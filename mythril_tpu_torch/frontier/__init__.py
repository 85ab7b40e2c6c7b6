"""The device frontier, ported: the K-step segment over B paths in lockstep.

The port's counterpart of ``mythril_tpu/frontier/``, as far as the engine's
device interface: ``push_state`` -> ``segment`` -> ``pull_harvest`` ->
``HostArena.pull_from_device``.

Module map:
  * ``ops``      — arena/term op codes, handler families, halt and event kinds
  * ``arena``    — host mirror of the device term arena (encode/decode)
  * ``code``     — per-instruction dispatch tables compiled from bytecode
  * ``state``    — the struct-of-arrays frontier state (numpy host mirror)
  * ``step``     — the segment (plain PyTorch, and the CUDA kernel
                   ``csrc/frontier_segment.cu``) and its transfers
  * ``interop``  — numpy <-> tensor conversion in the JAX layout, digests
"""
