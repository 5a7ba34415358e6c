"""Optimizer and gradient reduction of the language-model training path:
AdamW with optional int8 block-quantized moments, and the int8-compressed
data-parallel gradient sum (the port of ``repro.optim``)."""
