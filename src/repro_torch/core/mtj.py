"""MTJ device constants (paper Table 3) for the write-driver calibration.

The slice of ``repro.core.mtj`` the serving path needs: the Table-3 cell
parameters and the thermal stability factor Delta(T). The s-LLGS
integrator and the Fig. 6/7 curves are simulation work the serving path
never runs; they are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# physical constants (SI)
KB = 1.380649e-23        # Boltzmann, J/K
MU_B = 9.2740100783e-24  # Bohr magneton, J/T
E_CHARGE = 1.602176634e-19
GAMMA = 1.76086e11       # gyromagnetic ratio, rad/(s.T)
MU_0 = 4.0e-7 * math.pi


@dataclasses.dataclass(frozen=True)
class MTJParams:
    """Paper Table 3 defaults (PMA STT-MTJ, 32 nm flow)."""
    area_m2: float = 16e-15
    tmr_0: float = 2.0
    t_ox: float = 8.5e-10
    ra_ohm_um2: float = 5.0
    i_c0: float = 200e-6
    t_free: float = 1.3e-9
    r_p: float = 4.2e3
    r_ap: float = 6.6e3
    temperature: float = 300.0
    delta0: float = 60.0
    alpha: float = 0.01
    ms: float = 1.05e6
    h_k: float = 1.8e5
    tau0: float = 1.0e-9
    spin_polarization: float = 0.62


DEFAULT_MTJ = MTJParams()


def delta_of_t(p: MTJParams, t) -> np.ndarray:
    """Thermal stability factor Delta(T) = E/(kB T), float32 like the
    reference: the barrier falls mildly with T, the 1/T term dominates."""
    t = np.asarray(t, np.float32)
    e0 = np.float32(p.delta0 * KB * 300.0)
    barrier = e0 * np.maximum(np.float32(1.0) - np.float32(1.0e-3)
                              * (t - np.float32(300.0)), np.float32(0.05))
    return (barrier / (np.float32(KB) * t)).astype(np.float32)
