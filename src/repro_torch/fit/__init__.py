from .linear import FitData, descriptor_rows, fit_snap_linear  # noqa: F401
