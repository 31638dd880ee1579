"""Rank processes for the port's data-parallel tests, spawned on the CPU.

Imports torch and the port only, so a spawned rank starts in a second or
two. ``run_step_rank`` runs the cases of a job file through the sharded
train step over gloo; ``run_cli_rank`` runs ``train_torch.py``'s ``main``
with the environment ``torchrun`` gives a rank. Both write their results to
a file per rank.
"""

from __future__ import annotations

import contextlib
import hashlib
import multiprocessing
import os
import socket
import sys

import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 240


def _rank_env(threads: int = 2):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(threads)


def state_digest(state) -> dict:
    """A sha256 per tensor of the whole train state: G, D, G_ema (parameters
    and buffers), both optimizers' moments, and the counts."""
    out = {}
    for net in ("G", "D", "G_ema"):
        for k, v in getattr(state, net).state_dict().items():
            out[f"{net}.{k}"] = hashlib.sha256(v.detach().cpu().numpy().tobytes()).hexdigest()
    for net in ("G", "D"):
        opt, module = getattr(state, f"opt_{net}"), getattr(state, net)
        for (name, p) in module.named_parameters():
            for m in opt.moment_names:
                out[f"opt_{net}.{name}.{m}"] = hashlib.sha256(
                    opt.state[p][m].cpu().numpy().tobytes()).hexdigest()
        out[f"opt_{net}.counts"] = (opt.count, opt.sched_count)
    out["itr"] = state.itr
    return out


def run_cases(cases: list, mesh) -> list:
    """Each case of a job through ``make_sharded_train_step`` on ``mesh``
    (``None``: one process on the whole batch). A case: ``config``, the
    initial ``G``/``D``/``G_ema`` state dicts, global ``x`` and ``y``,
    ``steps``, either ``schedule`` (global draws, one list per step) or
    ``seed`` (a generator in the same state on every rank), and optionally
    ``prior``, the prior-feature table the case runs with (the process's
    own table is restored after it). Returns per case the metrics of every
    step; the gradients of the first step and the state dicts and Adam
    moments after it; and the digest of the final state."""
    from ieagan_torch.ops import prior

    results = []
    for case in cases:
        table = prior._FEATURES
        if "prior" in case:
            prior.set_prior_features(case["prior"])
        try:
            results.append(_run_case(case, mesh))
        finally:
            prior._FEATURES = table
    return results


def _snapshot(state, mets) -> dict:
    return {
        "grads": {"G": mets["_grads_G"], "D": mets["_grads_D"]},
        "state": {net: {k: v.clone() for k, v in getattr(state, net).state_dict().items()}
                  for net in ("G", "D", "G_ema")},
        "moments": {net: {n: {m: getattr(state, f"opt_{net}").state[p][m].clone()
                              for m in ("mu", "nu")}
                          for n, p in getattr(state, net).named_parameters()}
                    for net in ("G", "D")}}


def _run_case(case: dict, mesh) -> dict:
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.parallel.sharding import host_local_batch, make_sharded_train_step
    from ieagan_torch.train.optim import make_optimizers
    from ieagan_torch.train.step import TrainState

    cfg = case["config"]
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    G_ema = Generator.from_config(cfg)
    for module, name in ((G, "G"), (D, "D"), (G_ema, "G_ema")):
        module.load_state_dict(case[name], strict=True)
    G_ema.eval().requires_grad_(False)
    state = TrainState(G.train(), D.train(), G_ema, *make_optimizers(G, D, cfg))
    x, y = host_local_batch(mesh, case["x"], case["y"])
    generator = torch.Generator().manual_seed(case.get("seed", 0))
    result = {"metrics": []}
    for i in range(case["steps"]):
        schedule = case["schedule"][i] if "schedule" in case else None
        step = make_sharded_train_step(G, D, cfg, mesh, draw_schedule=schedule,
                                       capture_grads=i == 0)
        mets = step(state, x, y, generator)
        result["metrics"].append({k: v for k, v in mets.items() if not k.startswith("_")})
        if i == 0:
            result.update(_snapshot(state, mets))
    result["digest"] = state_digest(state)
    return result


def bn_forward(job: dict, mesh) -> dict:
    """G's forward in train mode on this rank's rows (global moments when
    ``mesh`` spans several ranks) and the gradient of a fixed weighting of
    its output (the mean of ``out * w``): output rows, every BN buffer,
    every parameter gradient."""
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.parallel.collectives import all_reduce_grads, global_batch
    from ieagan_torch.parallel.sharding import host_local_batch

    G = Generator.from_config(job["config"])
    G.load_state_dict(job["G"], strict=True)
    G.train()
    z, y, rdof, w = host_local_batch(mesh, job["z"], job["y"], job["rdof"], job["w"])
    with global_batch(mesh):
        out = G(z, y, rdof)
    # mean(out * w) over the global batch is the mean of the ranks' means,
    # whose gradient all_reduce_grads gives from each rank's
    torch.mean(out.float() * w).backward()
    for p in G.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_grads(G, mesh)
    return {"out": out.detach(), "buffers": {k: v.clone() for k, v in G.named_buffers()},
            "grads": {k: p.grad.clone() for k, p in G.named_parameters()}}


def run_step_rank(rank: int, world: int, init_file: str, job_path: str, out_dir: str):
    """One rank of a job: join the gloo group through ``init_file``, run the
    job's BN case and step cases on this rank's rows, save the results as
    ``rank<r>.pt`` under ``out_dir``."""
    _rank_env()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        from ieagan_torch.core.mesh import make_mesh
        mesh = make_mesh(world)
        job = torch.load(job_path, weights_only=False)
        out = {"bn": bn_forward(job["bn"], mesh), "cases": run_cases(job["cases"], mesh)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with contextlib.closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class PooledExtractor:
    """A 16-d stand-in for Inception (4x4 average-pooled images): the FID
    pipeline around the extractor, without a 2048-d sqrtm per FID."""
    device = torch.device("cpu")

    def features(self, images):
        return torch.nn.functional.adaptive_avg_pool2d(images[:, :1], 4).flatten(1)

    def __call__(self, images):
        return self.features(torch.as_tensor(images)).numpy()


def run_cli_rank(rank: int, world: int, port: int, argv: list, env: dict, out_dir: str):
    """``train_torch.py``'s ``main(argv)`` as ``torchrun`` starts a rank
    (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), on the CPU, the FID extractor a 16-d stand-in; its
    output goes to ``rank<r>.log`` and the state's digest and the run's
    bookkeeping to ``rank<r>.pt`` under ``out_dir``."""
    _rank_env()
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), IEAGAN_PLATFORM="cpu")
    from ieagan_torch.eval import fid
    from ieagan_torch.train.cli import main
    extractor = PooledExtractor()
    fid.default_extractor = lambda config=None, device="cpu": extractor
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        state, sd = main(argv)
        print("done", flush=True)
    torch.save({"digest": state_digest(state), "state_dict": sd},
               os.path.join(out_dir, f"rank{rank}.pt"))


def run_single(job_path: str, out_dir: str):
    """One process taking the whole batch of a job (no process group): the
    job's BN case, its step cases and its ``control`` cases, saved as
    ``single.pt`` under ``out_dir``."""
    _rank_env()
    job = torch.load(job_path, weights_only=False)
    out = {"bn": bn_forward(job["bn"], None), "cases": run_cases(job["cases"], None),
           "control": run_cases(job.get("control", []), None)}
    torch.save(out, os.path.join(out_dir, "single.pt"))


def start_processes(targets: list) -> list:
    """Start each ``(target, args)`` in a spawned process; returns them."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for target, args in targets]
    for p in procs:
        p.start()
    return procs


def join_processes(procs: list, timeout: float = RANK_TIMEOUT_S):
    """Wait for ``procs``, each up to ``timeout``; kill any still alive,
    then raise if one failed."""
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise RuntimeError(f"process exit codes {codes} (a negative code: killed at the "
                           f"{timeout:.0f} s limit or by a signal)")


def rank_targets(target, world: int, args: tuple) -> list:
    """``(target, (rank, world, *args))`` for each rank."""
    return [(target, (r, world, *args)) for r in range(world)]


def spawn_ranks(target, world: int, args: tuple, timeout: float = RANK_TIMEOUT_S):
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes;
    raise if one fails or outlives ``timeout``."""
    join_processes(start_processes(rank_targets(target, world, args)), timeout)


if __name__ == "__main__":
    sys.exit("a helper of tests/test_torch_parallel.py and tests/test_torch_driver.py")
