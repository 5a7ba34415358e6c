"""The benchmark's plain reference: SNAP energy and forces and NVE
integration in float64, in plain PyTorch.  It imports nothing of the
program under test."""
