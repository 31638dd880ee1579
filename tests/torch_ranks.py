"""Rank processes for the port's data- and tensor-parallel tests, spawned
on the CPU.

Imports torch and the port only, so a spawned rank starts in a second or
two. ``run_step_rank`` runs the cases of a job file through the sharded
train step over gloo; ``run_tp_rank`` does so on a mesh with a model axis,
with its checkpoint and module checks; ``run_cli_rank`` runs
``train_torch.py``'s ``main`` with the environment ``torchrun`` gives a
rank. Each writes its results to a file per rank.
"""

from __future__ import annotations

import contextlib
import hashlib
import multiprocessing
import os
import socket
import sys
import threading

import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 240
_ENVIRON = threading.Lock()  # start_processes from several threads


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
    own table is restored after it), and ``save``, a dir to checkpoint the
    state after the first step into. Returns per case the metrics of every
    step; the gradients of the first step and the state dicts and Adam
    moments after it (split leaves gathered whole); the digest of the final
    state and, on a mesh with a model axis, the elements this rank holds of
    every parameter and moment."""
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


def _snapshot(state, grads) -> dict:
    return {
        "grads": grads,
        "state": {net: {k: v.clone() for k, v in getattr(state, net).state_dict().items()}
                  for net in ("G", "D", "G_ema")},
        "moments": {net: {n: {m: getattr(state, f"opt_{net}").state[p][m].clone()
                              for m in ("mu", "nu")}
                          for n, p in getattr(state, net).named_parameters()}
                    for net in ("G", "D")}}


def case_state(case: dict, mesh):
    """The ``TrainState`` of a case's config and initial weights (fresh Adam
    moments), holding this rank's shards on a mesh with a model axis."""
    from ieagan_torch.models.discriminator import Discriminator
    from ieagan_torch.models.generator import Generator
    from ieagan_torch.parallel.sharding import split_state
    from ieagan_torch.train.optim import make_optimizers
    from ieagan_torch.train.step import TrainState

    cfg = case["config"]
    G, D = Generator.from_config(cfg), Discriminator.from_config(cfg)
    G_ema = Generator.from_config(cfg)
    for module, name in ((G, "G"), (D, "D"), (G_ema, "G_ema")):
        module.load_state_dict(case[name], strict=True)
    G_ema.eval().requires_grad_(False)
    return split_state(TrainState(G.train(), D.train(), G_ema, *make_optimizers(G, D, cfg),
                                  compute_dtype=torch.get_default_dtype()), mesh)


def local_numels(state) -> dict:
    """The number of elements this rank holds of every parameter of G, D and
    G_ema and of every Adam moment."""
    out = {}
    for net in ("G", "D", "G_ema"):
        module = getattr(state, net)
        opt = getattr(state, f"opt_{net}", None)
        for name, p in module.named_parameters():
            out[f"{net}.{name}"] = p.numel()
            for m in (() if opt is None else opt.moment_names):
                out[f"opt_{net}.{name}.{m}"] = opt.state[p][m].numel()
    return out


@contextlib.contextmanager
def float64_compute():
    """Inside the block tensors are made in float64, and ``Tensor.float()``,
    with which the port widens a narrower type to at least float32 (batch
    norm's moments, attention's logits, tanh), keeps a float64 tensor as it
    is: a case run inside computes in float64 throughout. Two correct
    programs that sum in different orders then agree to float64 rounding,
    where in float32 a pre-ReLU value within rounding of zero can take
    either subgradient."""
    default, widen = torch.get_default_dtype(), torch.Tensor.float
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda t, *a, **k: t if t.dtype == torch.float64 else widen(t, *a, **k)
    try:
        yield
    finally:
        torch.Tensor.float = widen
        torch.set_default_dtype(default)


def _to_float64(item):
    """A case's floating tensors (in dicts and lists) in float64."""
    if isinstance(item, dict):
        return {k: _to_float64(v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_to_float64(v) for v in item)
    if isinstance(item, torch.Tensor) and item.is_floating_point():
        return item.double()
    return item


def _run_case(case: dict, mesh) -> dict:
    """One case; with ``float64`` set, in float64 (``float64_compute``)."""
    if not case.get("float64"):
        return _run_case_as_given(case, mesh)
    with float64_compute():
        return _run_case_as_given(_to_float64(case), mesh)


def _run_case_as_given(case: dict, mesh) -> dict:
    from ieagan_torch.parallel.sharding import (full_state, full_tensors, host_local_batch,
                                                make_sharded_train_step)

    cfg = case["config"]
    state = case_state(case, mesh)
    G, D = state.G, state.D
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
            grads = {net: full_tensors(getattr(state, net), mets[f"_grads_{net}"], mesh)
                     for net in ("G", "D")}
            with full_state(state, mesh):
                result.update(_snapshot(state, grads))
            if "save" in case:
                _save(state, mesh, case["save"])
    result["digest"] = state_digest(state)
    if mesh is not None and mesh.n_model > 1:
        result["numel"] = local_numels(state)
    return result


def _save(state, mesh, path):
    """Checkpoint ``copy<itr>`` of ``state`` under ``path``, written by rank
    0 from the whole state."""
    from ieagan_torch.parallel.sharding import full_state
    from ieagan_torch.utils.checkpoint import save_checkpoint

    with full_state(state, mesh):
        if mesh is None or mesh.rank == 0:
            save_checkpoint(path, state, {}, f"copy{state.itr}")
        if mesh is not None:
            dist.barrier()


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


def checkpoint_round_trip(job: dict, mesh) -> dict:
    """Load the one-process checkpoint ``job["load"]`` (dir, tag) into a
    state of ``job["case"]`` under ``mesh`` (each rank keeps its shards),
    save it again under ``job["resave"]``, and return the whole state as
    loaded (every tensor of G, D, G_ema and the Adam moments) with the
    counts."""
    from ieagan_torch.parallel.sharding import full_state
    from ieagan_torch.utils.checkpoint import load_checkpoint

    state = case_state(job["case"], mesh)
    path, tag = job["load"]
    load_checkpoint(path, state, tag, mesh=mesh)
    numel = local_numels(state)
    with full_state(state, mesh):
        whole = _snapshot(state, {})
        whole["counts"] = (state.itr, state.opt_G.count, state.opt_D.count)
    _save(state, mesh, job["resave"])
    whole["numel"] = numel
    return whole


def split_attention(job: dict, mesh) -> dict:
    """The RRM's attention of ``job`` (``MultiheadSelfAttention`` with its
    weights) split over ``mesh``'s model axis: its output, the input's
    gradient and the parameters' gradients (gathered whole) of the sum of
    ``out * w``, and which of its layers were split and paired."""
    from ieagan_torch.ops.rrm import MultiheadSelfAttention
    from ieagan_torch.ops.spectral import Linear
    from ieagan_torch.parallel import tensor
    from ieagan_torch.parallel.sharding import full_tensors, split_rule

    m = MultiheadSelfAttention(job["dim"], job["heads"], Linear)
    m.load_state_dict(job["weights"])
    for name, split in tensor.layer_splits(m, split_rule(m, mesh.n_model), mesh).items():
        tensor.split_layer(m.get_submodule(name), split)
    x = job["x"].clone().requires_grad_(True)
    out = m(x)
    torch.sum(out * job["w"]).backward()
    return {"out": out.detach(), "x_grad": x.grad,
            "grads": full_tensors(m, {n: p.grad for n, p in m.named_parameters()}, mesh),
            "splits": {n: (s.tp.style, s.tp.paired) for n, s in tensor.split_layers(m)}}


def run_tp_rank(rank: int, world: int, init_file: str, job_path: str, out_dir: str):
    """One rank of a tensor-parallel job: join the gloo group through
    ``init_file``, run the job's step cases on its ``mesh`` (n_data,
    n_model), then its checkpoint round trip (``checkpoint``) and its split
    attention (``attention``, on a 1 x world mesh) where the job has them;
    save the results as ``rank<r>.pt`` under ``out_dir``."""
    _rank_env()
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        from ieagan_torch.core.mesh import make_mesh
        job = torch.load(job_path, weights_only=False)
        mesh = make_mesh(*job["mesh"])
        out = {"cases": run_cases(job["cases"], mesh)}
        if "checkpoint" in job:
            out["checkpoint"] = checkpoint_round_trip(job["checkpoint"], mesh)
        if "attention" in job:
            out["attention"] = split_attention(job["attention"], make_mesh(1, world))
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
    job's step cases, its BN case and its ``control`` cases where it has
    them, saved as ``single.pt`` under ``out_dir``."""
    _rank_env()
    job = torch.load(job_path, weights_only=False)
    out = {"cases": run_cases(job["cases"], None)}
    if "bn" in job:
        out["bn"] = bn_forward(job["bn"], None)
    if "control" in job:
        out["control"] = run_cases(job["control"], None)
    torch.save(out, os.path.join(out_dir, "single.pt"))


def start_processes(targets: list) -> list:
    """Start each ``(target, args)`` in a spawned process; returns them.
    Their OpenMP threads sleep while they wait (``OMP_WAIT_POLICY``): the
    ranks wait on each other in every collective, and spinning threads
    would take the cores the other ranks and the test's workers need."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args) for target, args in targets]
    with _ENVIRON:
        policy = os.environ.get("OMP_WAIT_POLICY")
        os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
        try:
            for p in procs:
                p.start()
        finally:
            if policy is None:
                del os.environ["OMP_WAIT_POLICY"]
            else:
                os.environ["OMP_WAIT_POLICY"] = policy
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
