"""The multi-node x multi-card check (port of ``parallel/hybrid.py``).

The production layout of a multi-node deployment puts the ``data`` axis
across nodes and the ``model`` axis (with fsdp's shards) inside each
node. ``launch_hybrid_check`` lays that out without the hardware: it
spawns ``n_nodes x local_ranks`` gloo processes on the CPU with
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``GROUP_RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
and each one (``child_main``) builds the (nodes, local ranks) mesh,
checks that the node boundary lies on the ``data`` axis, takes one dp x
(tp + fsdp) fp32 step of ``UNet(features=(32, 128), bottleneck=256)`` and
asserts that the global loss equals a one-process step's within 1e-5 and
is the same on every rank. The launch retries once on a fresh port, as
JAX's does: a gloo rendezvous can miss its window on a busy host.

  python -c "from audiodenoiser_torch.parallel import launch_hybrid_check as c; print(c())"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CHILD = "from audiodenoiser_torch.parallel.hybrid import child_main; child_main()"


def child_main() -> None:
    """One rank's part (the launcher's environment must be set)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from audiodenoiser_torch.models.unet import UNet
    from audiodenoiser_torch.parallel.distributed import maybe_initialize
    from audiodenoiser_torch.parallel.mesh import make_mesh, shard_batch, shard_train_state
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    torch.set_num_threads(1)
    assert maybe_initialize("cpu"), "expected the launcher's environment"
    n_nodes = dist.get_world_size() // int(os.environ["LOCAL_WORLD_SIZE"])
    mesh = make_mesh(model_parallel=int(os.environ["LOCAL_WORLD_SIZE"]), device="cpu")
    node = torch.tensor([int(os.environ["GROUP_RANK"])])
    row = [torch.zeros_like(node) for _ in range(mesh.size(1))]
    dist.all_gather(row, node, group=mesh.get_group("model"))
    assert len({int(t) for t in row}) == 1, "the node boundary is not on the data axis"

    def make_state():
        return create_train_state(0, UNet(features=(32, 128), bottleneck=256), device="cpu")

    rng = np.random.default_rng(1)
    noisy = torch.from_numpy(np.abs(rng.standard_normal((2 * n_nodes, 1, 32, 32)))
                             .astype(np.float32))
    clean = torch.from_numpy(np.abs(rng.standard_normal((2 * n_nodes, 1, 32, 32)))
                             .astype(np.float32))
    state = shard_train_state(make_state(), mesh, fsdp=True)
    n_sharded = len(state.layout.model_dims) + sum(
        hasattr(p, "to_local") for p in state.model.parameters())
    assert n_sharded > 0, "tp+fsdp sharded nothing"
    _, losses = train_step(state, shard_batch(noisy, mesh), shard_batch(clean, mesh))
    total = losses.total.detach().clone()
    dist.all_reduce(total, group=mesh.get_group("data"))
    total = float(total) / mesh.size(0)
    _, ref_losses = train_step(make_state(), noisy, clean)
    ref = float(ref_losses.total)
    assert np.isfinite(total) and abs(total - ref) < 1e-5 * max(1.0, abs(ref)), (total, ref)
    every = [torch.zeros(1, dtype=torch.float64) for _ in range(dist.get_world_size())]
    dist.all_gather(every, torch.tensor([total], dtype=torch.float64))
    assert all(float(t) == total for t in every), every
    print(f"HYBRID_OK rank={dist.get_rank()}/{dist.get_world_size()} node="
          f"{os.environ['GROUP_RANK']} mesh={{'data': {mesh.size(0)}, 'model': {mesh.size(1)}}} "
          f"sharded_leaves={n_sharded} loss={total:.6f} ref={ref:.6f}", flush=True)
    dist.destroy_process_group()


def _env(port: int, node: int, local: int, n_nodes: int, local_ranks: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(node * local_ranks + local), WORLD_SIZE=str(n_nodes * local_ranks),
               GROUP_RANK=str(node), LOCAL_RANK=str(local), LOCAL_WORLD_SIZE=str(local_ranks),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [_ROOT, env.get("PYTHONPATH")])))
    return env


def launch_hybrid_check(n_nodes: int = 2, local_ranks: int = 2, timeout: float = 300.0) -> str:
    """Spawn the ranks and return rank 0's ``HYBRID_OK`` line; raises
    AssertionError with every rank's output when a second attempt fails too."""

    def run_once():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, "-c", _CHILD],
                                  env=_env(port, node, local, n_nodes, local_ranks),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  cwd=_ROOT)
                 for node in range(n_nodes) for local in range(local_ranks)]
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            return ["TIMEOUT"] * len(procs), procs
        return outs, procs

    outs = []
    for _attempt in (0, 1):
        outs, procs = run_once()
        if all(p.returncode == 0 and "HYBRID_OK" in o for p, o in zip(procs, outs)):
            return next(line.strip() for line in outs[0].splitlines() if "HYBRID_OK" in line)
    raise AssertionError("the hybrid dp (nodes) x tp + fsdp (local) check failed twice: "
                         + "\n".join(o[-3000:] for o in outs))
