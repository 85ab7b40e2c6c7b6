"""A spawn target for the pooled service tests: the port's pool worker,
run with JAX blocked, and what the test asks of it through the environment.

The pool spawns ``worker_main`` in a fresh interpreter, so a test's
monkeypatch does not reach it; the tests point the pool at this module's
``worker_main`` instead (``service.pool.worker_main``), and the child sets
up what these variables name before it runs the port's:

* ``MYTHRIL_TORCH_TEST_FORCE``: the frontier forced once the worker has
  configured its flags (the recorded runs' configuration);
* ``MYTHRIL_TORCH_TEST_FAULT=<torch error>:<site>:<file>``: that ``torch``
  error is raised once across the pool (by the first child to remove
  ``<file>``) at ``<site>``: ``frontier`` (the shared drain), ``probe``
  (the interactive probe's scope) or ``host`` (a job's host continuation);
* ``MYTHRIL_TORCH_TEST_MODULES=<dir>``: at a clean exit the child writes the
  names of the modules it loaded to ``<dir>/<pid>.json``.

It imports nothing of the JAX package, nor ``tests._torch_parity``.
"""

import json
import os
import sys


def worker_main(worker_id, config, job_q, event_q, control_q=None):
    sys.modules["jax"] = None  # any import of jax raises
    if os.environ.get("MYTHRIL_TORCH_TEST_FORCE"):
        from mythril_tpu_torch.facade import warm

        apply = warm.apply_analyzer_args

        def apply_forced(cmd_args):
            from mythril_tpu_torch.support.support_args import args

            apply(cmd_args)
            args.frontier_force = True

        warm.apply_analyzer_args = apply_forced
    fault = os.environ.get("MYTHRIL_TORCH_TEST_FAULT")
    if fault:
        _inject(*fault.split(":", 2))
    from mythril_tpu_torch.service import worker

    worker.worker_main(worker_id, config, job_q, event_q, control_q)
    out = os.environ.get("MYTHRIL_TORCH_TEST_MODULES")
    if out:
        loaded = sorted(k for k, v in sys.modules.items() if v is not None)
        with open(os.path.join(out, f"{os.getpid()}.json"), "w") as f:
            json.dump(loaded, f)


def _inject(name: str, site: str, once: str) -> None:
    """Wrap the function at ``site`` so that its first call after ``once``
    is removed raises ``torch.<name>``."""
    import torch

    def first(real):
        def wrapped(*a, **kw):
            try:
                os.remove(once)
            except FileNotFoundError:
                return real(*a, **kw)
            raise getattr(torch, name)("injected")

        return wrapped

    if site == "frontier":
        from mythril_tpu_torch.frontier import engine

        engine.drain_lasers = first(engine.drain_lasers)
    elif site == "probe":
        from mythril_tpu_torch.facade.warm import WorkerContext

        WorkerContext.probe_scope = first(WorkerContext.probe_scope)
    else:
        from mythril_tpu_torch.core.svm import LaserEVM

        LaserEVM.exec = first(LaserEVM.exec)
