"""The plan verifier's elastic reshard rule, ahead of the rest of the pass.

Counterpart of ``mlsl_tpu.analysis.plan`` in part: ``verify_reshard``
(``plan.py:820-911``, codes MLSL-A140/A141), which the elastic coordinator
(``mlsl_tpu_torch.elastic``) runs on every reshard plan before it moves a
byte, unconditionally. The rest of the pass -- ``verify`` and
``verify_severity`` at ``Session.commit`` and in the compiled engine, and the
issue-order, in-flight, quantization-geometry, donation and ring-accounting
rules (A101-A132) -- is ROADMAP A.7d's.
"""

from __future__ import annotations

from typing import Optional

from mlsl_tpu_torch.analysis.diagnostics import Report


def verify_reshard(plan: dict, report: Optional[Report] = None) -> Report:
    """Prove an elastic reshard plan (mlsl_tpu_torch.elastic.build_reshard_plan)
    moves every ZeRO-1 shard element exactly once BEFORE it executes.

    Per layer: ``sources`` are (old-rank, lo, hi) intervals over the old
    padded flat layout that must tile ``[0, count)`` exactly — a gap loses
    optimizer state, an overlap double-applies it (A140) — and ``targets``
    are (new-rank, lo, hi) intervals that must tile ``[0, padded_new)`` in
    ownership-chunk geometry (k_new per rank; A141 when the target geometry
    disagrees with the survivor world's shard math). The coordinator runs
    this unconditionally (not gated by MLSL_VERIFY): a covering bug here
    silently corrupts the training state it exists to carry."""
    rep = report if report is not None else Report("plan")
    d_old = int(plan.get("d_old", 0))
    d_new = int(plan.get("d_new", 0))
    if d_old < 1 or d_new < 1:
        rep.add("MLSL-A141",
                f"reshard world sizes invalid: d_old={d_old}, d_new={d_new}",
                "graph:reshard")
        return rep
    for layer in plan.get("layers", ()):
        name = layer.get("name", "?")
        anchor = f"graph:reshard/{name}"
        count = int(layer["count"])
        padded_old = int(layer["padded_old"])
        padded_new = int(layer["padded_new"])
        k_old = int(layer["k_old"])
        k_new = int(layer["k_new"])
        if padded_old != k_old * d_old or padded_old < count:
            rep.add("MLSL-A141",
                    f"source geometry: padded_old {padded_old} != "
                    f"k_old {k_old} x d_old {d_old} (count {count})", anchor)
        if padded_new != k_new * d_new or padded_new < count:
            rep.add("MLSL-A141",
                    f"target geometry: padded_new {padded_new} != "
                    f"k_new {k_new} x d_new {d_new} (count {count}) — the "
                    "survivor world's ownership chunks cannot hold this "
                    "layer", anchor)
        # -- A140: sources tile [0, count) exactly once ---------------------
        src = sorted(
            (int(lo), int(hi), int(r)) for r, lo, hi in layer["sources"]
        )
        pos = 0
        for lo, hi, r in src:
            if lo < pos:
                rep.add("MLSL-A140",
                        f"source interval [{lo}, {hi}) of old rank {r} "
                        f"overlaps coverage up to {pos}: an element would "
                        "be applied twice", anchor)
            elif lo > pos:
                rep.add("MLSL-A140",
                        f"coverage gap [{pos}, {lo}) before old rank {r}'s "
                        "interval: those shard elements would be dropped",
                        anchor)
            if not (0 <= lo <= hi <= padded_old) or (
                    hi > lo and (k_old < 1  # no chunk can own an interval
                                 or lo // k_old != (hi - 1) // k_old
                                 or lo // k_old != r)):
                rep.add("MLSL-A140",
                        f"source interval [{lo}, {hi}) does not lie inside "
                        f"old rank {r}'s owned chunk "
                        f"[{r * k_old}, {(r + 1) * k_old})", anchor)
            pos = max(pos, hi)
        if pos != count:
            rep.add("MLSL-A140",
                    f"sources cover [0, {pos}) but the layer holds {count} "
                    "real elements", anchor)
        # -- targets tile [0, padded_new) in ownership-chunk geometry -------
        tgt = sorted(
            (int(lo), int(hi), int(r)) for r, lo, hi in layer["targets"]
        )
        pos = 0
        for i, (lo, hi, r) in enumerate(tgt):
            if lo != pos or r != i or hi - lo != k_new:
                rep.add("MLSL-A141",
                        f"target interval [{lo}, {hi}) of new rank {r} is "
                        f"not the ownership chunk "
                        f"[{i * k_new}, {(i + 1) * k_new})", anchor)
            pos = hi
        if pos != padded_new or len(tgt) != d_new:
            rep.add("MLSL-A141",
                    f"targets cover [0, {pos}) across {len(tgt)} rank(s); "
                    f"the survivor world needs [0, {padded_new}) across "
                    f"{d_new}", anchor)
    return rep
