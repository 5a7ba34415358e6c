"""The paper's 2J=14 benchmark: 2000 atoms, 26 neighbors, 204 bispectrum
components (Fig. 3 / Fig. 4; the problem size that ran out of memory
before the adjoint refactorization)."""
from repro_torch.core.snap import SnapConfig

CONFIG = dict(
    snap=SnapConfig(twojmax=14, rcut=4.7, rfac0=0.99363, rmin0=0.0,
                    switch_flag=True, bzero_flag=True),
    natoms=2000, nnbor=26, lattice='bcc', lattice_a=3.1652,
    name='snap-2j14',
)
