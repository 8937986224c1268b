"""The rank job of tests/test_torch_parallel.py: the launcher's ``cases``
(``lewton_tpu_torch/parallel/launch.py``) with two more kinds of case that
only the tests need. Run as ``--job tests/_torch_parallel_jobs.py:cases``;
it imports no JAX."""

import torch
import torch.distributed as dist

from lewton_tpu_torch.parallel import launch
from lewton_tpu_torch.parallel.batch import mesh_device


def run_case(mesh, case: dict) -> tuple[dict, dict]:
    """:func:`launch.run_case`, and:

    - kind ``fail``: rank ``rank`` raises; the others wait in an all-reduce
      that never completes (the parent must end them);
    - ``expect_error`` (an exception's class name): the case must raise it;
      its record is the message, and the job goes on."""
    if case["kind"] == "fail":
        if dist.get_rank() == case["rank"]:
            raise RuntimeError(f"rank {case['rank']} fails on purpose")
        dist.all_reduce(torch.zeros(1, device=mesh_device(mesh)))
        raise AssertionError("the all-reduce completed without a rank")
    want = case.get("expect_error")
    if want is None:
        return launch.run_case(mesh, case)
    try:
        launch.run_case(mesh, case)
    except Exception as e:  # noqa: BLE001 -- held to expect_error
        if type(e).__name__ != want:
            raise
        return {"error": f"{type(e).__name__}: {e}"}, {}
    raise AssertionError(f"case {case['name']}: no {want}")


def cases(mesh, args) -> None:
    launch.job_cases(mesh, args, run=run_case)
