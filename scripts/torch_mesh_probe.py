"""Phase 8m of ``chip_smoke.py`` alone: the device mesh (``parallel/``) on
four logical shards of the card and, where several cards are visible, over
every card.

    python3 scripts/torch_mesh_probe.py [--out FILE]

Builds the kernels from the checkout, then runs ``chip_smoke.mesh_runs``:
the sharded probe, ``frontier_step``, the partitioned segment example, the
pod runs, and the mesh against ``--no-mesh`` on the pod contract and the
wide contract of 7 branches, each run timed (one pair on the logical
shards, in turns mesh, off, off, mesh over several cards).  Then the
partitioned segment against the single launch, in turns, on recorded
dispatches of ``tests/testdata/torch_frontier_dispatches.npz`` (the wide
contract's, a rubixi one and largecode's first two, each first timed
alone by ``chip_smoke.time_frontier`` with its bound): on 4 logical shards
and, where several cards are visible, over every card
(``chip_smoke.time_partitioned``).  Prints the card's name and power
limit, the phase's lines, and as its last line the rows as one JSON object
(also written to FILE).  Exits 1 when a check fails and 2 without a card.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


# recorded dispatches timed partitioned: (run name, index)
DISPATCHES = (("wide_contract_10", 0), ("rubixi_like", 2), ("largecode_contract_2400", 0),
              ("largecode_contract_2400", 1))


def partitioned_by_dispatch(torch, chip_smoke) -> dict:
    from tests.test_torch_frontier_fixture import iter_dispatches

    chip_smoke.phase("the partitioned segment against the single launch on recorded dispatches")
    names = {name for name, _ in DISPATCHES}
    kept = [(name, i, d) for name, i, d in iter_dispatches(
        keep=lambda name, i, data: name in names and (name, i) in DISPATCHES)]
    chip_smoke.check(kept, "no recorded dispatch to time")
    single = chip_smoke.time_frontier(torch, kept)
    shapes = [r["shape"] for r in single]
    out = {"single": single, "logical": chip_smoke.time_partitioned(
        torch, kept, single, [torch.device("cuda", 0)] * chip_smoke.MESH_SHARDS, pick=shapes)}
    cards = torch.cuda.device_count()
    if cards > 1:
        n = max(k for k in (2, 4, 8) if k <= cards)
        out["cards"] = chip_smoke.time_partitioned(
            torch, kept, single, [torch.device("cuda", k) for k in range(n)], pick=shapes)
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mythril_tpu_torch.ops import _build

    logging.getLogger("mythril_tpu_torch.plugins.loader").setLevel(logging.ERROR)
    try:
        card = chip_smoke.card_line()
        print(card)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        chip_smoke.phase("build")
        _build.build()
        _build.load()
        _launches, row = chip_smoke.mesh_runs(torch, card)
        row["partitioned_by_dispatch"] = partitioned_by_dispatch(torch, chip_smoke)
    except chip_smoke.SmokeFailure as e:
        print(f"torch_mesh_probe: FAILED: {e}", file=sys.stderr)
        return 1
    line = json.dumps({"card": card, "mesh": row}, default=str)
    if "--out" in argv:
        out = Path(argv[argv.index("--out") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
