"""Pipeline schedule generators: FThenB, 1F1B, interleaved-VPP, zero-bubble
(paddle_tpu/distributed/meta_parallel/pipeline_schedules.py, copied as it
is: the instruction streams are the contract between the pipeline ranks,
and every rank computes the same streams).

Reference analogs:
- 1F1B + interleaved runtime schedules:
  fleet/meta_parallel/pipeline_parallel.py:459 (forward_backward_pipeline),
  :1010 (PipelineParallelWithInterleave)
- static-graph schedule passes (instruction-list builders per stage):
  distributed/passes/pipeline_scheduler_pass/ (FThenB, 1F1B, VPP,
  pipeline_zero_bubble.py ZB-H1)

Design: schedules are pure data — per-stage lists of instructions
``(kind, micro, chunk)`` with kind in {"F", "B", "W"}:

  F: forward of one micro-batch through one model chunk
  B: backward-for-inputs (dx) of that chunk          (ZB splits B/W;
  W: backward-for-weights (dw) of that chunk          classic schedules
                                                      fuse W into B)

A clock-driven simulator (`simulate`) validates cross-stage dependencies
(F needs the previous virtual stage's F of the same micro; B needs the
next virtual stage's B; W needs its own B) and measures makespan, from
which bubble ratios are computed — the property tests pin the textbook
bubble formulas. The same instruction streams drive the eager executors
in pipeline_parallel.py, mirroring how the reference's scheduler passes
feed its static interpreter.

Virtual-stage numbering: chunk c on stage s is global virtual stage
``gv = c * num_stages + s`` (Megatron/VPP convention; reference
pp_layers.py interleave segmentation).
"""
from __future__ import annotations

from typing import List, Tuple

__all__ = [
    "gen_fthenb", "gen_1f1b", "gen_interleave_1f1b", "gen_zero_bubble_h1",
    "simulate", "bubble_ratio",
]

Instr = Tuple[str, int, int]   # (kind, micro, chunk)


def gen_fthenb(stage: int, num_stages: int, num_micro: int) -> List[Instr]:
    """All forwards, then all backwards (reference FThenB pass)."""
    return ([("F", m, 0) for m in range(num_micro)]
            + [("B", m, 0) for m in range(num_micro)])


def gen_1f1b(stage: int, num_stages: int, num_micro: int) -> List[Instr]:
    """Classic 1F1B (reference forward_backward_pipeline :459): stage s
    runs (P-1-s) warmup forwards, then alternates F/B, then drains."""
    warmup = min(num_stages - 1 - stage, num_micro)
    sched: List[Instr] = [("F", m, 0) for m in range(warmup)]
    nf, nb = warmup, 0
    while nf < num_micro:
        sched.append(("F", nf, 0)); nf += 1
        sched.append(("B", nb, 0)); nb += 1
    while nb < num_micro:
        sched.append(("B", nb, 0)); nb += 1
    return sched


def gen_interleave_1f1b(stage: int, num_stages: int, num_micro: int,
                        num_chunks: int) -> List[Instr]:
    """Interleaved/VPP 1F1B (reference :1010; Megatron-style). Each stage
    owns `num_chunks` model chunks; micro-batches are issued in groups of
    P so chunk (c) of group g runs before chunk (c+1). Requires
    num_micro % num_stages == 0 (the reference asserts the same)."""
    p, v, m = num_stages, num_chunks, num_micro
    if v == 1:
        return gen_1f1b(stage, p, m)
    if m % p != 0:
        raise ValueError(
            f"interleaved schedule needs num_micro % num_stages == 0 "
            f"(got {m} % {p})")
    total = m * v
    group = p * v

    def f_micro_chunk(k):          # k-th forward on this stage
        g, r = divmod(k % (group), p)
        return (k // group) * p + r, g

    def b_micro_chunk(k):          # k-th backward on this stage
        g, r = divmod(k % (group), p)
        return (k // group) * p + r, v - 1 - g

    warmup = min((p - stage - 1) * 2 + (v - 1) * p, total)
    sched: List[Instr] = []
    nf = nb = 0
    for _ in range(warmup):
        mi, c = f_micro_chunk(nf); nf += 1
        sched.append(("F", mi, c))
    while nf < total:
        mi, c = f_micro_chunk(nf); nf += 1
        sched.append(("F", mi, c))
        mi, c = b_micro_chunk(nb); nb += 1
        sched.append(("B", mi, c))
    while nb < total:
        mi, c = b_micro_chunk(nb); nb += 1
        sched.append(("B", mi, c))
    return sched


def gen_zero_bubble_h1(stage: int, num_stages: int,
                       num_micro: int) -> List[Instr]:
    """ZB-H1 (reference pipeline_zero_bubble.py): backward is split into
    B (input grads, on the critical path) and W (weight grads, fillable).
    Built by greedy list-scheduling with priority B > F > W under the
    1F1B warmup structure — W instructions slot into what would otherwise
    be bubbles, and the drain phase becomes B...B W...W."""
    scheds = _zb_h1_all_stages(num_stages, num_micro)
    return scheds[stage]


def _zb_h1_all_stages(p: int, m: int) -> List[List[Instr]]:
    # global greedy simulation, one tick per op (F=B=W=1 as in ZB-H1)
    warmup = [min(p - s, m) for s in range(p)]   # one extra vs 1F1B
    f_done = [[None] * m for _ in range(p)]      # completion ticks
    b_done = [[None] * m for _ in range(p)]
    nf = [0] * p
    nb = [0] * p
    nw = [0] * p
    out: List[List[Instr]] = [[] for _ in range(p)]
    t = 0
    while any(nw[s] < m for s in range(p)):
        progressed = False
        for s in range(p):
            # B ready: own F done, downstream B done (strictly before t)
            can_b = (nb[s] < nf[s]
                     and f_done[s][nb[s]] is not None
                     and f_done[s][nb[s]] <= t
                     and (s == p - 1
                          or (b_done[s + 1][nb[s]] is not None
                              and b_done[s + 1][nb[s]] <= t)))
            # F ready: upstream F done; hold 1F1B-style pacing after warmup
            can_f = (nf[s] < m
                     and (s == 0 or (f_done[s - 1][nf[s]] is not None
                                     and f_done[s - 1][nf[s]] <= t))
                     and (nf[s] < warmup[s] or nb[s] + warmup[s] > nf[s]
                          or can_b is False))
            if can_b:
                out[s].append(("B", nb[s], 0))
                b_done[s][nb[s]] = t + 1
                nb[s] += 1
                progressed = True
            elif can_f:
                out[s].append(("F", nf[s], 0))
                f_done[s][nf[s]] = t + 1
                nf[s] += 1
                progressed = True
            elif nw[s] < nb[s]:
                out[s].append(("W", nw[s], 0))
                nw[s] += 1
                progressed = True
        t += 1
        if not progressed and t > 10 * (2 * m + 2 * p) + 100:
            raise RuntimeError("zero-bubble scheduler wedged")
    return out


# ---------------------------------------------------------------------------
# validation / simulation
# ---------------------------------------------------------------------------

def simulate(scheds: List[List[Instr]], num_stages: int, num_micro: int,
             num_chunks: int = 1) -> int:
    """Clock-simulate per-stage instruction streams; raise on any
    dependency violation or deadlock; return the makespan in ticks
    (each instruction costs 1 tick; stages run concurrently).

    Dependencies enforced:
      F(m, gv)  needs F(m, gv-1)                  [gv = c*P + s]
      B(m, gv)  needs F(m, gv) and B(m, gv+1)
      W(m, gv)  needs B(m, gv)
    """
    p, v = num_stages, num_chunks
    q = p * v
    f_done = {}
    b_done = {}
    ptr = [0] * p
    clock = [0] * p
    pending = sum(len(s) for s in scheds)
    while pending:
        progressed = False
        for s in range(p):
            if ptr[s] >= len(scheds[s]):
                continue
            kind, mi, c = scheds[s][ptr[s]]
            gv = c * p + s
            t = clock[s]
            if kind == "F":
                dep = 0 if gv == 0 else f_done.get((mi, gv - 1))
                if dep is None or dep > t:
                    continue
                f_done[(mi, gv)] = t + 1
            elif kind == "B":
                own = f_done.get((mi, gv))
                dn = 0 if gv == q - 1 else b_done.get((mi, gv + 1))
                if own is None or own > t or dn is None or dn > t:
                    continue
                b_done[(mi, gv)] = t + 1
            else:  # W
                own = b_done.get((mi, gv))
                if own is None or own > t:
                    continue
            ptr[s] += 1
            clock[s] = t + 1
            pending -= 1
            progressed = True
        if not progressed:
            # all stages blocked: advance blocked stages' clocks to the
            # earliest dependency-completion (idle/bubble time)
            nxt = None
            for s in range(p):
                if ptr[s] >= len(scheds[s]):
                    continue
                kind, mi, c = scheds[s][ptr[s]]
                gv = c * p + s
                need = []
                if kind == "F" and gv > 0:
                    need.append(f_done.get((mi, gv - 1)))
                elif kind == "B":
                    need.append(f_done.get((mi, gv)))
                    if gv < q - 1:
                        need.append(b_done.get((mi, gv + 1)))
                elif kind == "W":
                    need.append(b_done.get((mi, gv)))
                if any(n is None for n in need):
                    continue   # producer not even scheduled yet this pass
                t_ready = max([0] + [n for n in need if n is not None])
                if t_ready > clock[s]:
                    nxt = t_ready if nxt is None else min(nxt, t_ready)
            if nxt is None:
                raise RuntimeError(
                    f"pipeline schedule deadlock: ptr={ptr}")
            for s in range(p):
                if ptr[s] < len(scheds[s]) and clock[s] < nxt:
                    clock[s] = nxt
    return max(clock)


def bubble_ratio(makespan: int, num_stages: int, num_micro: int,
                 num_chunks: int = 1, has_w: bool = False) -> float:
    """Fraction of stage-time idle: (makespan - work_per_stage)/makespan."""
    per_stage = num_micro * num_chunks * (3 if has_w else 2)
    return (makespan - per_stage) / makespan
