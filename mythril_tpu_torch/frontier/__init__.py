"""The device frontier, ported: B paths stepped in lockstep on the device.

The port's counterpart of ``mythril_tpu/frontier/``: the synchronous
engine around the K-step segment (the CUDA kernel on the card, its plain
PyTorch version on the CPU).

Module map:
  * ``ops``      — arena/term op codes, handler families, halt and event kinds
  * ``arena``    — host mirror of the device term arena (encode/decode)
  * ``code``     — per-instruction dispatch tables compiled from bytecode
  * ``state``    — the struct-of-arrays frontier state (numpy host mirror)
  * ``step``     — the segment (plain PyTorch, and the CUDA kernel
                   ``csrc/frontier_segment.cu``) and its transfers
  * ``interop``  — numpy <-> tensor conversion in the JAX layout, digests
  * ``records``  — host-side path lineage (fork tree) bookkeeping
  * ``taint``    — taint bits over the arena row graph
  * ``walker``   — replays device events through host GlobalStates so
                   detection modules see identical states
  * ``harvest``  — event ingestion, replay and slot-order commit
  * ``stats``    — the frontier's counters
  * ``engine``   — orchestration + LaserEVM integration
"""

__all__ = ["FrontierEngine"]


def __getattr__(name: str):
    # lazy: detection modules import frontier.taint at load time, and an
    # eager engine import here would pull the segment and torch's device
    # code into every detector load
    if name == "FrontierEngine":
        from mythril_tpu_torch.frontier.engine import FrontierEngine

        return FrontierEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
