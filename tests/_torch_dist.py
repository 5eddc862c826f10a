"""Runs of the PyTorch port over gloo ranks on the CPU, for the parallel tests.

`Ranks(job, payload, tmp_path, world)` writes `payload` with `torch.save`,
starts one process per rank (`python tests/_torch_dist.py ...`, with no JAX
import), which join a gloo group on a free localhost port, and returns at
once; its `results()` waits for them and gives each rank's result of
`JOBS[job](payload)` in rank order. A test file starts its runs before its
first test, so they run while the test process computes its references.
The workers use one intra-op thread each, and do not import TensorBoard.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Ranks:
    """The processes of one run of `job` over `world` gloo ranks, started;
    `results()` waits for them (asserting each exited 0) and returns each
    rank's result in rank order; `stop()` kills what still runs."""

    def __init__(self, job: str, payload: dict, tmp_path, world: int = 2, timeout: float = 300):
        tmp = str(tmp_path)
        os.makedirs(tmp, exist_ok=True)
        payload_path = os.path.join(tmp, f"{job}_payload.pt")
        torch.save(payload, payload_path)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.outs = [os.path.join(tmp, f"{job}_rank{r}.pt") for r in range(world)]
        self.timeout = timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, payload_path, str(r), str(world), port,
             self.outs[r]], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        self._results = None

    def results(self) -> list:
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=self.timeout)[0].decode(errors="replace"))
            finally:
                self.stop()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
            self._results = [torch.load(path, weights_only=False) for path in self.outs]
        return self._results

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# jobs (run in the workers)
# ---------------------------------------------------------------------------
def _tiny_world(base, num_heads=None):
    from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
    from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
    from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig

    cfg = UNetConfig.tiny()
    if num_heads is not None:
        cfg = dataclasses.replace(cfg, num_heads=num_heads)
    unet = UNet2DCondition(cfg).eval().requires_grad_(False)
    unet.load_state_dict(base)
    schedule = make_schedule()
    solver = make_train_solver(
        schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
        endpoints="0,259,519,779", forward_endpoints="259,519,779,999")
    return unet, schedule, solver


def _steps(payload, mesh_of) -> dict:
    """Each of payload["steps"] ({name: dict(fsdp=, tp=, min_size=, tcfg=,
    draws=, seed=, num_heads=)}) on the rank's rows of payload["batch"],
    with the trainer's FSDP_MIN_SIZE set to min_size (default 2**16) for
    it. Under fsdp > 1 the store's gathers are read: `peak` the most
    gathered bytes alive at once during the step, `live` those still alive
    when it returned, `units` the most units with gathered bytes alive at
    once, `unit_max` the most one unit of one dict (base or teacher)
    gathers, `whole` what a gather of everything makes."""
    from invertible_cd_tpu_torch.parallel import shard_batch
    from invertible_cd_tpu_torch.training import make_train_step, trainer

    out = {}
    default_min_size = trainer.FSDP_MIN_SIZE
    for name, run in payload["steps"].items():
        unet, schedule, solver = _tiny_world(payload["base"], run.get("num_heads"))
        mesh = mesh_of(run["fsdp"], run.get("tp", 1))
        trainer.FSDP_MIN_SIZE = run.get("min_size", default_min_size)
        try:
            step_fn = make_train_step(unet, payload["base"], payload["base"], solver, schedule,
                                      run["tcfg"], mesh)
        finally:
            trainer.FSDP_MIN_SIZE = default_min_size
        store = step_fn.weights
        if store is not None:
            store.reset_peak()
        gen = None if run.get("seed") is None else torch.Generator().manual_seed(run["seed"])
        batch = {k: v for k, v in payload["batch"].items() if k in run.get("keys", payload["batch"])}
        new, metrics = step_fn(payload["state"], shard_batch(batch, mesh), gen, run.get("draws"))
        out[name] = dict(state=new, metrics={k: float(v) for k, v in metrics.items()},
                         resident=step_fn.resident_bytes(), rows=mesh.rows, row=mesh.row)
        if store is not None:
            out[name].update(peak=store.peak_bytes, live=store.live_bytes, units=store.peak_units,
                             unit_max=max(store.gathered_bytes(k, dicts=(i,))
                                          for k in step_fn.units.values() for i in (0, 1)),
                             whole=store.gathered_bytes())
    return out


def job_train(payload) -> dict:
    from invertible_cd_tpu_torch.parallel import make_mesh

    meshes = {}
    return _steps(payload, lambda fsdp, tp: meshes.setdefault(
        (fsdp, tp), make_mesh(fsdp=fsdp, tp=tp, device="cpu")))


def job_parallel(payload) -> dict:
    """The train steps, the gathered eval, dp serving and the two-rank
    generate and train CLIs."""
    import numpy as np

    from invertible_cd_tpu_torch.cli import generate, train_icd
    from invertible_cd_tpu_torch.parallel import make_mesh
    from invertible_cd_tpu_torch.serving import BatchingExecutor, serve_follower
    from invertible_cd_tpu_torch.testing import tiny_bundle
    from invertible_cd_tpu_torch.training.eval import eval_inversion, sample_for_fid

    meshes = {}

    def mesh_of(fsdp, tp=1):
        return meshes.setdefault((fsdp, tp), make_mesh(fsdp=fsdp, tp=tp, device="cpu"))

    out = {"steps": _steps(payload, mesh_of), "tp_pair": _tp_pair(payload["tp_pair"])}
    mesh = mesh_of(1)
    pipe = tiny_bundle(None)
    ev = payload["eval"]
    out["sample_for_fid"] = sample_for_fid(
        lambda b, g: pipe.generate(list(b), generator=g)[0], ev["prompts"], ev["batch_size"],
        seed=ev["seed"], device="cpu", mesh=mesh)
    out["eval_inversion"] = eval_inversion(*ev_fns(), ev["latents"], batch_size=ev["batch_size"],
                                           decode_fn=ev_decode, scorer=OrderScorer(),
                                           val_context=ev["context"], mesh=mesh)
    serve = payload["serve"]
    if mesh.rank == 0:
        with BatchingExecutor(pipe, batch_size=len(serve["prompts"]), max_delay=1.0,
                              mesh=mesh) as ex:
            futs = [ex.submit(p, seed=s) for p, s in zip(serve["prompts"], serve["seeds"])]
            out["served"] = np.stack([f.result(timeout=120) for f in futs])
            out["serve_stats"] = ex.stats()
    else:
        out["served_batches"] = serve_follower(pipe, mesh)
    generate.main(payload["generate_argv"])
    out["train_cli"] = train_icd.main(payload["train_argv"])
    out.update(_sp_tp(payload["sp_tp"]))
    return out


def _sp_tp(p) -> dict:
    """sp = 2 and tp = 2 on the two ranks, on the bundle of p["weights"]:
    one UNet call on each rank's rows of the height (and the rows gathered),
    a generate at sp = 2, a served burst at sp = 2 (rank 0 the executor, rank
    1 the follower), a generate under int8 at sp = 2, then the bundle's UNet
    split over tp: its state dict, a generate, and a generate under int8."""
    import numpy as np

    from invertible_cd_tpu_torch.parallel import gather_rows, latent_rows, make_mesh
    from invertible_cd_tpu_torch.parallel.spatial import spatial
    from invertible_cd_tpu_torch.parallel.tp import tensor_parallel
    from invertible_cd_tpu_torch.serving import BatchingExecutor, serve_follower
    from invertible_cd_tpu_torch.testing import tiny_bundle

    sp, tp = make_mesh(sp=2, device="cpu"), make_mesh(tp=2, device="cpu")
    out = {"meshes": {"sp2": mesh_record(sp), "tp2": mesh_record(tp)}}
    pipe = tiny_bundle(p["weights"])
    u = p["unet"]
    with torch.inference_mode(), spatial(sp):
        rows = pipe.unets["reverse"](latent_rows(u["latent"], sp), u["t"], u["context"], w_cond=u["w"])
    out["sp_unet_rows"] = rows.shape
    out["sp_unet"] = gather_rows(rows, sp)
    out["sp_generate"] = pipe.generate(p["prompts"], latent=p["sp_latent"], mesh=sp)
    serve = p["serve"]
    if sp.rank == 0:
        with BatchingExecutor(pipe, batch_size=len(serve["prompts"]), max_delay=1.0, mesh=sp) as ex:
            futs = [ex.submit(q, seed=s) for q, s in zip(serve["prompts"], serve["seeds"])]
            out["sp_served"] = np.stack([f.result(timeout=120) for f in futs])
            out["sp_serve_stats"] = ex.stats()
    else:
        out["sp_served_batches"] = serve_follower(pipe, sp)
    pipe.quantize = "int8"
    out["sp_int8_generate"] = pipe.generate(p["prompts"], latent=p["int8_latent"], mesh=sp)
    pipe.quantize = "off"
    tensor_parallel(pipe.unets["reverse"], tp)
    out["tp_state"] = {k: v.clone() for k, v in pipe.unets["reverse"].state_dict().items()}
    out["tp_generate"] = pipe.generate(p["prompts"], latent=p["tp_latent"])
    pipe.quantize = "int8"
    out["tp_int8_generate"] = pipe.generate(p["prompts"], latent=p["int8_latent"])
    return out


def _tp_pair(p) -> dict:
    """tp's reductions at tp = 2 (each rank half of a feed-forward): the
    rows mean (`all_reduce_mean`) of a tensor both ranks hold, beside the
    sum over every rank over the rows that it was before; then a
    column-split layer (its input through `to_tp`) followed by a row-split
    one (`RowSplitLinear`, `from_tp`), forward and gradients, through the
    device path of the collectives and through the host path (the one gloo
    takes for CUDA tensors), and, for comparison, the same layers with the
    sum written in place and no `to_tp` (the reductions as they were)."""
    import torch.nn as nn
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.parallel import all_reduce_mean, make_mesh, mesh as mesh_module, to_tp
    from invertible_cd_tpu_torch.parallel.tp import RowSplitLinear, _rows

    tp = make_mesh(tp=2, device="cpu")
    i = tp.coordinate("tp")
    t = p["mean_input"]
    old = t.clone()
    dist.all_reduce(old)  # over every rank, divided by the rows
    out = {"rows_mean": all_reduce_mean([t], tp)[0], "old_mean": old / tp.rows}
    d, f = p["w1"].shape[1], p["w1"].shape[0]
    col, row = nn.Linear(d, f), nn.Linear(f, d)
    with torch.no_grad():
        for layer, w, b in ((col, p["w1"], p["b1"]), (row, p["w2"], p["b2"])):
            layer.weight.copy_(w)
            layer.bias.copy_(b)
    cols = torch.arange(i * f // 2, (i + 1) * f // 2)
    col_s, row_s = _rows(col, cols), RowSplitLinear(row, tp, cols)
    params = [col_s.weight, col_s.bias, row_s.weight, row_s.bias]
    for p_ in params:
        p_.requires_grad_(True)
    real = mesh_module._through_host
    for path in ("device", "host", "in_place"):
        x = p["x"].clone().requires_grad_(True)
        if path == "in_place":
            h = F.gelu(col_s(x))
            y = F.linear(h, row_s.weight).float()
            dist.all_reduce(y)  # written into the tracked tensor: autograd does not see it
            y = y + row_s.bias
        else:
            mesh_module._through_host = (lambda t, group: True) if path == "host" else real
            try:
                h = to_tp(x, tp)
                version = h._version
                y = row_s(F.gelu(col_s(h)))
            finally:
                mesh_module._through_host = real
        grads = torch.autograd.grad((y * p["g"]).sum(), [x] + params)
        out[path] = dict(y=y.detach(), dx=grads[0], dw1=grads[1], db1=grads[2], dw2=grads[3],
                         db2=grads[4], cols=cols)
        if path != "in_place":
            fns, todo = set(), [y.grad_fn]
            while todo:  # the output's graph back to the input
                fn = todo.pop()
                if fn is not None and type(fn).__name__ not in fns:
                    fns.add(type(fn).__name__)
                    todo.extend(f for f, _ in fn.next_functions)
            out[path].update(input_version_kept=h._version == version, grad_fns=fns)
    return out


def mesh_record(mesh) -> dict:
    """What a rank sees of a mesh: its shape, its coordinates, its rows and
    the global ranks of its sp and tp groups."""
    return {"shape": mesh.shape, "coords": {a: mesh.coordinate(a) for a in mesh.shape},
            "rows": (mesh.rows, mesh.row),
            "groups": {a: dist.get_process_group_ranks(mesh.group(a))
                       for a in ("dp", "fsdp", "sp", "tp", "rows")}}


def job_dp_sp(payload) -> dict:
    """dp = 2 x sp = 2 over four ranks, on the bundle of payload["weights"]:
    each dp group generates its row of payload["prompts"] from its row of
    payload["latent"], the height split over its sp pair; every rank
    gathers the images over dp, and records the mesh. Then fsdp = 2 x tp =
    2: the train steps of payload["train"], the mesh, and the rows mean of
    payload["mean_input"] (a tensor that depends on the rank)."""
    from invertible_cd_tpu_torch.parallel import (
        all_gather_objects, all_reduce_mean, make_mesh, process_local_batch_slice)
    from invertible_cd_tpu_torch.testing import tiny_bundle

    fsdp_tp = make_mesh(dp=1, fsdp=2, tp=2, device="cpu")
    train = {"steps": _steps(payload["train"], lambda fsdp, tp: fsdp_tp),
             "mesh": mesh_record(fsdp_tp),
             "rows_mean": all_reduce_mean([payload["mean_input"] * (1 + fsdp_tp.rank)], fsdp_tp)[0]}

    mesh = make_mesh(dp=2, sp=2, device="cpu")
    pipe = tiny_bundle(payload["weights"])
    lo, n = process_local_batch_slice(len(payload["prompts"]), mesh)
    images, _ = pipe.generate(payload["prompts"][lo:lo + n], latent=payload["latent"][lo:lo + n],
                              mesh=mesh)
    rows = all_gather_objects((mesh.coordinate("sp"), images), mesh)
    return {"mesh": mesh_record(mesh), "rows": (lo, n),
            "images": torch.cat([im for i, im in rows if i == 0]), "train": train}


def ev_fns():
    """Round-trip stand-ins whose outputs depend on the chunk's generator
    and context."""
    def invert_fn(chunk, gen, ctx):
        return chunk + torch.randn(chunk.shape, generator=gen) + ctx.mean()

    def reconstruct_fn(noisy, gen, ctx):
        return 0.5 * noisy + torch.rand(noisy.shape, generator=gen) - ctx.mean()
    return invert_fn, reconstruct_fn


def ev_decode(latents):
    return torch.sigmoid(latents[..., :3].repeat_interleave(2, 1).repeat_interleave(2, 2))


class OrderScorer:
    """A stand-in FID scorer whose value depends on every image and on
    their order."""

    def fid(self, images, reference_images=None, reference_stats_path=None):
        import numpy as np

        return float(sum((k + 1) * int(np.asarray(im, np.int64).sum()) for k, im in enumerate(images)))


JOBS = {"train": job_train, "parallel": job_parallel, "dp_sp": job_dp_sp}


def main():
    job, payload_path, rank, world, port, out_path = sys.argv[1:]
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    # the train CLI's logger would take TensorBoard, whose import can pull in
    # TensorFlow (~17 s); the parallel tests read its JSONL rows only
    sys.modules["torch.utils.tensorboard"] = None
    from invertible_cd_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"localhost:{port}", int(world), int(rank), device="cpu")
    result = JOBS[job](torch.load(payload_path, weights_only=False))
    torch.save(result, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
