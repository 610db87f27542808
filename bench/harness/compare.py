"""The numbers that decide ``correct``, each beside its limit."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Number:
    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # NaN fails

    def line(self) -> str:
        mark = "ok" if self.ok else "FAILED"
        extra = f" ({self.note})" if self.note else ""
        return (f"check {self.name}: {self.value!r} limit {self.limit!r} "
                f"{mark}{extra}")


def moving_leaves(ref_grad: Dict[str, float], share: float = 1e-3
                  ) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    at least ``share`` of the median leaf's (a rule on the numbers, not
    on names)."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= share * med]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖ of the leaf, the median
    leaf's ‖ref‖): the gap between the program's norm and the
    reference's, not the norm of their difference."""
    med = statistics.median(ref[k] for k in leaves)
    out = {}
    for k in leaves:
        scale = max(ref[k], med)
        out[k] = abs(prog[k] - ref[k]) / scale if scale > 0 else float("inf")
    return out


def worst_and_median(gaps: Dict[str, float]) -> Tuple[float, str, float]:
    """(the worst leaf's gap, that leaf, the median leaf's gap)."""
    at = max(gaps, key=lambda k: (gaps[k] != gaps[k], gaps[k]))
    return gaps[at], at, statistics.median(gaps.values())


def leaf_norms(tree, base=None) -> Dict[str, float]:
    """Per-leaf float64 norms of ``tree`` (or of ``tree - base``)."""
    import torch
    out = {}
    for k, v in tree.items():
        d = v.double() if base is None else v.double() - base[k].double()
        out[k] = float(torch.linalg.vector_norm(d))
    return out
