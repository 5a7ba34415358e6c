"""The paper's 2J=8 benchmark: 2000 atoms, 26 neighbors, 55 bispectrum
components (Table I / Figs. 2, 4).  Tungsten-like bcc lattice with the
cutoff chosen to capture 26 neighbors (1st+2nd+3rd shells of bcc)."""
from repro_torch.core.snap import SnapConfig

CONFIG = dict(
    snap=SnapConfig(twojmax=8, rcut=4.7, rfac0=0.99363, rmin0=0.0,
                    switch_flag=True, bzero_flag=True),
    natoms=2000, nnbor=26, lattice='bcc', lattice_a=3.1652,  # W
    name='snap-2j8',
)
