"""The paper's Section 5 platform scenarios.

C = R = 10 mn, D = 1 mn, individual MTBF 125 years, N from 2^14 to 2^19
(platform MTBF from ~4000 mn down to ~125 mn).
"""

from ..core.waste import Platform

MN = 60.0

C = 10 * MN
D = 1 * MN
R = 10 * MN
MU_IND_YEARS = 125.0
MU_IND = MU_IND_YEARS * 365.25 * 86400.0

N_RANGE = [2**k for k in range(14, 20)]


def platform(n_procs: int, M: float | None = None) -> Platform:
    return Platform.from_components(MU_IND, n_procs, C, D, R, M=M)
