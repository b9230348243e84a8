"""Program profiles: the memory, work and collective card of one compiled
EL program on the card.

The reference (``repro.obs.prof``) reads XLA's ``cost_analysis()`` /
``memory_analysis()`` of a jitted program and parses its optimized HLO
for collectives.  A program of the port (``repro_torch.el.ingraph.
SyncProgram``, ``repro_torch.el.events.AsyncProgram``, a fleet cohort's
``repro_torch.el.sweep.CellBatch``) is static device buffers and, on a
card, one CUDA graph of a chunk of masked steps, so :func:`profile_jit`
measures that instead, field by field (see its docstring): the buffers'
bytes, the chunk's scratch peak from the caching allocator, the matmul
work of one step.  The profile is the static half of observability: the
telemetry rings (``repro_torch.obs.rings``) say what a run *did*, the
profile says what the program *is*.

Profiling is opt-in and cached once per program (``ELSession``:
``profile=`` / ``contract=`` or ``REPRO_EL_PROFILE=1``; ``FleetServer``:
``profile=``).

:class:`CollectiveContract` turns the profile into a dispatch-time
assertion (``contract.enforce(profile)`` raises
:class:`ContractViolation`), as in the reference.  On one card a program
issues no collectives, so ``collectives`` is ``{}`` and the default
contract (no collectives, nothing aliased for a solo program) holds.
The reference's HLO census parser (``parse_collectives`` /
``_type_bytes``) is not copied: nothing on one card feeds it; it returns
with the multi-card programs (ROADMAP Queue 1 item 14).
``repro_torch.obs`` never imports ``repro_torch.el``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.interop import tree_leaves

#: collective op mnemonics the census meters (the reference's HLO op
#: names)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


# ---------------------------------------------------------------------------
# ProgramProfile
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProgramProfile:
    """The static cost card of one compiled EL program.

    All fields are best-effort (``None`` when the device cannot report
    them, the reason in ``errors``); ``collectives`` maps op mnemonic →
    ``{"count", "bytes"}``.  ``peak_live_bytes`` is the reference's sum:
    arguments + outputs + temps − aliased.  :func:`profile_jit` says what
    each field holds for a program of the port.
    """

    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    transcendentals: Optional[float] = None
    argument_bytes: Optional[int] = None
    output_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None
    alias_bytes: Optional[int] = None
    generated_code_bytes: Optional[int] = None
    peak_live_bytes: Optional[int] = None
    collectives: Dict[str, Dict[str, float]] = \
        dataclasses.field(default_factory=dict)
    collective_bytes: int = 0
    hlo_lines: Optional[int] = None
    backend: Optional[str] = None
    donated: bool = False
    errors: Tuple[str, ...] = ()

    def collective_count(self, op: str) -> int:
        """Census count of one collective op (0 when absent)."""
        return int(self.collectives.get(op, {}).get("count", 0))

    @property
    def total_collectives(self) -> int:
        return sum(int(d.get("count", 0))
                   for d in self.collectives.values())

    def to_json(self) -> Dict[str, Any]:
        """A JSON-safe snapshot (``ELReport.telemetry["profile"]``)."""
        d = dataclasses.asdict(self)
        d["errors"] = list(self.errors)
        return d

    def summary(self) -> str:
        """One human line: flops, peak bytes, census."""
        cens = ", ".join(f"{op}={self.collective_count(op)}"
                         for op in COLLECTIVES
                         if self.collective_count(op)) or "none"
        flops = "?" if self.flops is None else f"{self.flops:.3g}"
        peak = ("?" if self.peak_live_bytes is None
                else f"{self.peak_live_bytes / 1e6:.2f}MB")
        return (f"flops={flops} peak={peak} alias={self.alias_bytes} "
                f"collectives[{cens}]")


def _count_flops(step) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        step()
    return float(counter.get_total_flops())


def _chunk_temp_bytes(device: torch.device, chunk) -> int:
    """The allocator's peak over ``chunk()`` less what was allocated
    before it."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    chunk()
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device) - before)


def profile_jit(program, *example_args, donated: bool = False
                ) -> ProgramProfile:
    """Profile a compiled EL program of the port on ``example_args``:
    ``(init_params, knobs)`` for a ``SyncProgram`` / ``AsyncProgram``,
    ``(stacked_carry, knobs, active)`` for a ``CellBatch``.  The program
    loads them into its static buffers (``program.profile_view``: no draw
    is taken, so the next run's draws are untouched) and, on a card,
    captures its chunk graph if it has none yet; the run that follows
    reuses both.

    What each field holds:

    * ``argument_bytes``: the program's static input buffers (params or
      the stacked carry, knobs, draw buffers);
    * ``output_bytes``: its finalized outputs (a run's params and
      ``out``; a cohort wave's stacked carry and status);
    * ``temp_bytes``: the peak of ``torch.cuda.max_memory_allocated``
      over one chunk's capture (whose warm-up runs that chunk eagerly and
      discards the result), or over that eager chunk when the graph
      exists, less what was allocated before;
    * ``peak_live_bytes``: arguments + outputs + temps − aliased;
    * ``alias_bytes``: 0, or with ``donated=True`` (a cohort's stacked
      carry, which the wave's graph updates in place) the bytes of the
      first example argument;
    * ``collectives``: ``{}`` and ``collective_bytes`` 0 (one card);
    * ``flops``: one masked step under ``torch.utils.flop_counter.
      FlopCounterMode``, which counts the matmul-family ops (``mm``,
      ``bmm``, ``addmm``, convolutions, attention): the SVM's scores and
      steps, not elementwise work or a custom kernel such as
      ``kmeans_assign``;
    * ``hlo_lines``, ``bytes_accessed``, ``transcendentals``,
      ``generated_code_bytes``: ``None`` (no compiler analysis);
    * ``backend``: the program's device type, ``"cuda"`` or ``"cpu"``.

    On the CPU the allocator keeps no statistics: ``temp_bytes`` and
    ``peak_live_bytes`` are ``None``, the reason in ``errors``.  Every
    section is best-effort: a failure is recorded in ``errors``.
    """
    errors: List[str] = []
    view = program.profile_view(*example_args)
    device = torch.device(view["device"])
    kw: Dict[str, Any] = {"donated": bool(donated),
                          "backend": device.type,
                          "argument_bytes": param_tree_bytes(
                              view["arguments"]),
                          "output_bytes": param_tree_bytes(view["outputs"]),
                          "alias_bytes": (param_tree_bytes(example_args[0])
                                          if donated else 0)}
    try:
        kw["flops"] = _count_flops(view["step"])
    except Exception as e:                                  # pragma: no cover
        errors.append(f"flops: {e}")
    if device.type == "cuda":
        kw["temp_bytes"] = _chunk_temp_bytes(device, view["chunk"])
        kw["peak_live_bytes"] = (kw["argument_bytes"] + kw["output_bytes"]
                                 + kw["temp_bytes"] - kw["alias_bytes"])
    else:
        errors.append(f"memory: the {device.type} allocator keeps no "
                      "peak statistics; temp_bytes and peak_live_bytes "
                      "are measured on a CUDA device")
    return ProgramProfile(errors=tuple(errors), **kw)


# ---------------------------------------------------------------------------
# Collective contracts
# ---------------------------------------------------------------------------


class ContractViolation(AssertionError):
    """A compiled program broke its declared collective/aliasing
    contract."""


#: a count constraint: an exact int or an inclusive ``(lo, hi)`` range
CountConstraint = Union[int, Tuple[int, int]]


def _check_count(op: str, actual: int, want: CountConstraint
                 ) -> Optional[str]:
    if isinstance(want, tuple):
        lo, hi = want
        if not (lo <= actual <= hi):
            return (f"{op}: count {actual} outside [{lo}, {hi}]")
        return None
    if actual != int(want):
        return f"{op}: count {actual} != {int(want)}"
    return None


@dataclasses.dataclass(frozen=True)
class CollectiveContract:
    """A declarative assertion over a :class:`ProgramProfile`.

    ``counts`` maps collective op mnemonics to an exact count or an
    inclusive ``(lo, hi)`` range; ops NOT named are unconstrained.
    ``alias_bytes`` (when set) must match the profile exactly — the
    donation contract is ``alias_bytes == param_bytes`` for donated
    programs and ``== 0`` otherwise.  ``check`` returns the violations
    (empty = pass); ``enforce`` raises :class:`ContractViolation`.

    The canonical instances::

        # sync-sharded on the 2x2 debug mesh: gather-before-reduce —
        # the edge stack is all-gathered BEFORE the aggregation einsum,
        # so the program must contain NO all-reduce (any partial-sum
        # reordering would break sharded-vs-unsharded bit-identity)
        CollectiveContract("sync-sharded-2x2",
                           counts={"all-gather": (1, 16),
                                   "all-reduce": 0})

        # donated run: the whole param tree is updated in place
        CollectiveContract("donated", alias_bytes=1920)
    """

    name: str = "contract"
    counts: Mapping[str, CountConstraint] = \
        dataclasses.field(default_factory=dict)
    alias_bytes: Optional[int] = None

    def check(self, profile: ProgramProfile) -> List[str]:
        """The list of violations (empty when the profile satisfies the
        contract)."""
        bad: List[str] = []
        for op, want in sorted(dict(self.counts).items()):
            msg = _check_count(op, profile.collective_count(op), want)
            if msg is not None:
                bad.append(msg)
        if self.alias_bytes is not None:
            actual = profile.alias_bytes
            if actual is None:
                bad.append("alias_bytes: unavailable (not measured)")
            elif int(actual) != int(self.alias_bytes):
                bad.append(f"alias_bytes: {actual} != {self.alias_bytes}")
        return bad

    def enforce(self, profile: ProgramProfile) -> None:
        bad = self.check(profile)
        if bad:
            raise ContractViolation(
                f"contract {self.name!r} violated: " + "; ".join(bad))


def param_tree_bytes(tree: Any) -> int:
    """Total bytes of a tree of tensors (numel x element size; numpy
    arrays as shape x itemsize) — the donated side of the alias
    contract."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            total += int(np.prod(np.shape(leaf), dtype=np.int64)
                         * np.dtype(leaf.dtype).itemsize)
    return total


#: loose all-gather bound for multi-device contracts (the reference's):
#: the exact count is a compiler detail — the invariant is >= 1 gather
#: and 0 all-reduces.
DEFAULT_GATHER_RANGE: Tuple[int, int] = (1, 16)


#: all-reduce allowance for sharded SCENARIO programs: the churn mask
#: arithmetic (active-edge counts, mask-renormalized weight sums,
#: slowest-ACTIVE-edge slot) reduces over the sharded edge axis as
#: partial-sum all-reduces.  These are scalar
#: control-plane reductions, not data-plane partial sums — the
#: gather-before-reduce discipline still governs the parameter path.
SCENARIO_REDUCE_RANGE: Tuple[int, int] = (0, 32)


def default_contract(*, mesh=None, donated: bool = False,
                     param_bytes: Optional[int] = None,
                     mode: str = "sync",
                     scenario: bool = False) -> CollectiveContract:
    """The contract every compiled EL program is expected to satisfy.

    * no mesh (or a 1-device mesh): NO collectives of any kind;
    * multi-device mesh (sync AND async): gather-before-reduce — at
      least one all-gather, zero all-reduce / reduce-scatter /
      all-to-all (bit-identity with the unsharded program forbids
      partial-sum reordering);
    * ``scenario`` (a ``ScenarioSpec``-path program) on a multi-device
      mesh: additionally up to ``SCENARIO_REDUCE_RANGE[1]`` all-reduces
      — the scalar churn-mask reductions over the sharded edge axis;
    * ``donated`` with ``param_bytes``: the whole param tree aliased
      (``alias_bytes == param_bytes``); non-donated: ``== 0``.
    """
    n_dev = 1
    if mesh is not None:
        n_dev = int(np.asarray(mesh.devices).size)
    if n_dev > 1:
        counts: Dict[str, CountConstraint] = {
            "all-gather": DEFAULT_GATHER_RANGE,
            "all-reduce": (SCENARIO_REDUCE_RANGE if scenario else 0),
            "reduce-scatter": 0, "all-to-all": 0}
    else:
        counts = {op: 0 for op in COLLECTIVES}
    alias = None
    if donated and param_bytes is not None:
        alias = int(param_bytes)
    elif not donated:
        alias = 0
    tag = "sharded" if n_dev > 1 else "replicated"
    if scenario:
        tag += "-scenario"
    return CollectiveContract(
        name=f"{mode}-{tag}" + ("-donated" if donated else ""),
        counts=counts, alias_bytes=alias)
