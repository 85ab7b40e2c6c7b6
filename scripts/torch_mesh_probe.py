"""Phase 8m of ``chip_smoke.py`` alone: the device mesh (``parallel/``) on
four logical shards of the card and, where several cards are visible, over
every card.

    python3 scripts/torch_mesh_probe.py [--out FILE]

Builds the kernels from the checkout, then runs ``chip_smoke.mesh_runs``:
the sharded probe, ``frontier_step``, the segment example, the pod runs,
and the mesh against ``--no-mesh`` on the pod contract and the wide
contract of 7 branches, each run timed (one pair on the logical shards, in
turns mesh, off, off, mesh over several cards).  Prints the card's name and
power limit, the phase's lines, and as its last line the phase's row as
one JSON object (also written to FILE).  Exits 1 when a check fails and 2
without a card.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


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
