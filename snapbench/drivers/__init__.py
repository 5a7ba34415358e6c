"""One module a driver: ``run(ctx)`` runs a cell's set-up, window and
check (see :mod:`snapbench.harness`)."""
