"""The language-model substrate: configs, layers and losses, attention
(with the flash backward), MoE, SSM blocks and the transformer stack, in
PyTorch (the port of ``repro.models``)."""
