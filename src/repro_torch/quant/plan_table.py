"""KernelPlanTable — the What/When/Where verdicts as a static routing
table (a copy of the JAX package's `quant/plan_table.py`).

`DecodeCore.kernel_plan` produces one planner `Decision` per decode GEMM;
this module freezes those verdicts into a hashable structure the model
stack consults per projection: a gated label runs the hand-written INT8
GEMM kernel, an ungated one the plain torch matmul.  The table is fixed
before the first step, so every step of a session takes the same routes.

Labels are the *short* projection names ("Wq", "mlp-down", "ssm-BCdt",
"lm_head", ...) — the `gemms_of_model` labels with the model-name prefix
stripped — so the table is independent of which config produced it.
Lookup of a label the planner never saw raises `KeyError` (listing the
known labels): model-side label drift must not silently disable gating.

Tables are **versioned** by content: `digest` is a stable hash of the
sorted entries (two tables built from the same decisions in any order
share it), which is what the adaptive serving layer keys its bounded
executable cache on and what telemetry reports as the plan version.
`flips(other)` diffs two versions by their "when" gate, and
`with_flip(label)` is the forced-flip harness used by the adaptive
tests/bench.
"""
from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One label's verdict: the paper's when (use_cim), what and where."""
    use_cim: bool
    what: str = "baseline"
    where: str = "PE"


def strip_model_prefix(label: str, model_name: str = "") -> str:
    prefix = f"{model_name} "
    return label[len(prefix):] if model_name and label.startswith(prefix) \
        else label


@dataclasses.dataclass(frozen=True)
class KernelPlanTable:
    """Hashable label -> PlanEntry map (fixed before the first step)."""
    entries: tuple[tuple[str, PlanEntry], ...] = ()

    @classmethod
    def from_decisions(cls, decisions: Iterable, model_name: str = ""
                       ) -> "KernelPlanTable":
        """Build from planner Decisions (e.g. ServeSession.kernel_plan
        values); `model_name` strips the `gemms_of_model` label prefix."""
        rows = []
        for d in decisions:
            lab = strip_model_prefix(d.gemm.label, model_name)
            rows.append((lab, PlanEntry(use_cim=bool(d.use_cim),
                                        what=d.what, where=d.where)))
        return cls(entries=tuple(sorted(rows)))

    @cached_property
    def _index(self) -> dict:
        return dict(self.entries)

    @property
    def labels(self) -> tuple:
        return tuple(lab for lab, _ in self.entries)

    def entry(self, label: str) -> PlanEntry:
        try:
            return self._index[label]
        except KeyError:
            raise KeyError(
                f"unknown GEMM label {label!r}: not in the kernel plan "
                f"(known labels: {sorted(self._index)})") from None

    def use_cim(self, label: str) -> bool:
        """The planner's "when" gate for one projection label.  Raises
        KeyError on labels absent from the plan — a renamed model-side
        projection must fail loudly, not silently run ungated."""
        return self.entry(label).use_cim

    def ungated(self) -> "KernelPlanTable":
        """Copy with every gate forced off (the parity-baseline program:
        identical labels and quantized weights, all-standard routing)."""
        return KernelPlanTable(entries=tuple(
            (lab, dataclasses.replace(e, use_cim=False))
            for lab, e in self.entries))

    # --- versioning -------------------------------------------------------

    @cached_property
    def digest(self) -> str:
        """Stable content hash — the table's *version*.  Entries are kept
        sorted by `from_decisions`, so two tables built from the same
        decisions in any order share one digest; any verdict change
        yields a new one.  (Python's built-in hash() is salted per
        process; this digest is reproducible across runs, so it can live
        in benchmark artifacts and serve telemetry.)"""
        return hashlib.sha256(repr(self.entries).encode()).hexdigest()[:12]

    def flips(self, other: "KernelPlanTable") -> tuple[str, ...]:
        """Labels whose "when" gate (use_cim) differs between the two
        versions; a label present in only one table counts as flipped."""
        labels = set(self._index) | set(other._index)
        out = []
        for lab in sorted(labels):
            a, b = self._index.get(lab), other._index.get(lab)
            if a is None or b is None or a.use_cim != b.use_cim:
                out.append(lab)
        return tuple(out)

    def with_flip(self, label: str) -> "KernelPlanTable":
        """Copy with one label's gate toggled — the deterministic
        forced-flip harness for the adaptive-serving tests and bench.
        Raises the KeyError-with-known-labels contract on unknown
        labels."""
        self.entry(label)          # enforce the drift gate
        return KernelPlanTable(entries=tuple(
            (lab, dataclasses.replace(e, use_cim=not e.use_cim)
             if lab == label else e)
            for lab, e in self.entries))
