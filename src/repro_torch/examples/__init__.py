"""The port's runnable examples, counterparts of the reference's
``examples/``: ``python -m repro_torch.examples.<name> [--device cpu]``
with ``quickstart``, ``md_nve``, ``serve_forces`` and ``fit_snap``.  Each
module's ``main(argv)`` prints its report and returns the printed values
as a dict; each runs on the card unless ``--device cpu`` is given."""
