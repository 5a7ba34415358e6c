"""The language-model serving substrate: configs, layers, attention, MoE,
SSM blocks and the transformer stack, in PyTorch (the port of
``repro.models``' forward and decode paths)."""
