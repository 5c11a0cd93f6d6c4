"""Per-iteration diagnostics, mirroring the reference's IterationUpdate.

ref: lightweaver/iteration_update.py
"""
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from .context import Context


@dataclass
class IterationUpdate:
    ctx: 'Context'
    crsw: float = 1.0
    updatedJ: bool = False
    dJMax: float = 0.0
    dJMaxIdx: int = 0
    updatedPops: bool = False
    dPops: List[float] = field(default_factory=list)
    ngAccelerated: bool = False
    updatedNe: bool = False
    dNeMax: float = 0.0
    updatedRho: bool = False
    dRho: List[float] = field(default_factory=list)
    NprdSubIter: int = 0
    dPopsMaxIdx: List[int] = field(default_factory=list)

    @property
    def dPopsMax(self) -> float:
        return max(self.dPops, default=0.0)

    @property
    def dRhoMax(self) -> float:
        return max(self.dRho, default=0.0)

    def compact_representation(self) -> str:
        s = []
        if self.crsw != 1.0:
            s.append(f'CRSW: {self.crsw:.2e}')
        if self.updatedJ:
            s.append(f'dJ = {self.dJMax:.2e}')
        if self.updatedPops:
            terms = ', '.join(f'{d:.2e}' for d in self.dPops)
            s.append(f'dPops = [{terms}]' + (' (accelerated)'
                                             if self.ngAccelerated else ''))
        if self.updatedNe:
            s.append(f'dNe = {self.dNeMax:.2e}')
        if self.updatedRho:
            terms = ', '.join(f'{d:.2e}' for d in self.dRho)
            s.append(f'dRho = [{terms}] ({self.NprdSubIter} sub-iter)')
        return ', '.join(s)
