"""Run a function on every rank of a one-host job.

``run(fn, world_size, args)`` starts ``world_size`` ranks, each joining the
process group through a ``FileStore`` in a fresh temporary directory (no
port to pick, so concurrent jobs cannot clash), calls ``fn(mesh, *args)``
on each and returns rank 0's result. Ranks beyond one are processes
started with ``torch.multiprocessing`` (spawn), each pinned to one
intra-op thread (multi-threaded CPU ``sqrt`` has drifted, ROADMAP Queue
3); the parent joins every rank within ``JOIN_TIMEOUT_S`` and kills them
all when one fails or the time runs out.
World size 1 runs in this process, still through a process group, so the
same collective code runs.

``fn`` must be a module-level function of an importable module (a spawned
rank imports it by name): ``parallel/ranks.py`` holds the ones the tests
and the chip smoke run. Tensors in rank 0's result come back as numpy
arrays.

    from dynamicfusion_body_tpu_torch.parallel import launch, ranks
    out = launch.run(ranks.fuse_depth, 4, (values, weights, depth, proj,
                                            kinv, tdist), backend="gloo")
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback

import torch
import torch.multiprocessing as mp

from .mesh import make_mesh

JOIN_TIMEOUT_S = 600.0


def _to_numpy(x):
    """``x`` with every tensor in it (in tuples, lists, dicts and
    NamedTuples) moved to a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _rank_main(rank, world, init_file, backend, fn, args):
    mesh = make_mesh(world, init_file, backend, rank)
    try:
        return _to_numpy(fn(mesh, *args))
    finally:
        mesh.close()


def _child(rank, world, init_file, backend, fn, args, results):
    torch.set_num_threads(1)
    try:
        out = _rank_main(rank, world, init_file, backend, fn, args)
        results.put((rank, "ok", out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, "error", traceback.format_exc()))
        raise


def run(fn, world_size: int, args=(), backend: str = "nccl"):
    """``fn(mesh, *args)`` on ``world_size`` ranks on ``backend`` ("nccl",
    the default, on the cards; "gloo" on the CPU). Returns rank 0's result
    (tensors as numpy arrays); raises RuntimeError with the rank's
    traceback when a rank fails, and after ``JOIN_TIMEOUT_S`` kills the
    ranks and raises TimeoutError."""
    with tempfile.TemporaryDirectory(prefix="dfb_launch_") as tmp:
        init_file = os.path.join(tmp, "store")
        if world_size == 1:
            return _rank_main(0, 1, init_file, backend, fn, args)
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_child, daemon=True, args=(
            r, world_size, init_file, backend, fn, args, results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        out, failure = None, None
        try:
            # drain the queue before joining (a rank blocks on its put)
            for _ in range(world_size):
                rank, status, value = results.get(timeout=JOIN_TIMEOUT_S)
                if status == "error":
                    failure = RuntimeError(
                        f"rank {rank} of {world_size} failed:\n{value}")
                    break
                if rank == 0:
                    out = value
            else:
                for p in procs:
                    p.join(timeout=JOIN_TIMEOUT_S)
        except queue.Empty:
            failure = TimeoutError(f"the {world_size} ranks did not finish "
                                   f"within {JOIN_TIMEOUT_S:.0f} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if failure is not None:
            raise failure
        return out
