"""One rank of a gloo process group on the CPU, for tests/test_torch_dp.py
and tests/test_torch_dist_shard.py: the counterpart of
tests/multihost_worker.py for the port. It imports no JAX, as a rank of the
port on a machine without JAX would not.

Run by the tests (``torch_parity.spawn``) as:
    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=<n> RANK=<r> \\
    LOCAL_RANK=<r> python tests/torch_dist_worker.py <dir> [<timeout s>]

``<dir>/jobs.pkl`` holds the jobs, made by the test from numpy-seeded
inputs (the same arrays it hands the JAX package). The rank joins the group
with ``init_distributed(device="cpu")`` (a collective timeout of
``<timeout s>``, by default ``TIMEOUT``), runs every job and writes what it
got to ``<dir>/rank<r>.pkl``. A job:

- ``step``: one ``make_dp_train_step`` step from the job's state on this
  rank's camera and images; with ``layout="2d"`` the 2-D step on JAX's
  ``data`` 2 x ``prim`` mesh of the ranks (``make_sharded_dp_train_step``),
  this rank holding its prim coordinate's rows (``grow_to`` grows the
  state first); with ``reference`` rank 0 also computes, in this process,
  the batch's step from every camera's ``camera_loss_grads`` (gradients
  summed in rank order and halved, stats summed and maxed,
  ``finish_train_step``);
- ``collectives``: ``psum``, ``pmean`` and ``pmax`` over both axes of a
  2 x 2 mesh of the ranks;
- ``exchange``: ``parallel.exchange`` with every rank sending to and
  receiving from every other at once, one ring step of ``RankParts`` and an
  exchange of nothing, recording the batches handed to
  ``dist.batch_isend_irecv``;
- ``slab`` / ``band``: ``render_prim_sharded`` / ``render_tile_sharded``
  with one part per rank, and the same render with the parts a local list
  in this process; with ``grad`` the gradient of sum(image²) by xyz of
  both; with ``trap`` the gradient again with the image gather's backward
  rule replaced by the sum;
- ``sharded_render`` / ``sharded_step``: ``make_sharded_render`` /
  ``make_sharded_train_step`` with one row shard per rank (this rank's
  rows only), and the same with the shards a local list of the whole
  state in this process;
- ``loop``: ``train(..., data_parallel=True)`` (or the job's ``train_kw``)
  on a COLMAP scene, with the densify draws handed in, recording the
  camera of every step and every file this rank opens for writing or
  directory it makes; with ``nan_at`` the loss of that step is made NaN
  under ``--debug``, and the loop's ``FloatingPointError`` is the job's
  result; with ``gui_port`` rank 0 binds the SIBR bridge there, waits for
  the test's client before it trains, and records how long each poll held
  it; under rank-sharded storage (``train_kw`` ``shard_gaussians``) every
  rank records each frame it renders with the bridge, and rank 0, with
  every rank's rows of the state at each frame gathered, renders the frame
  again in this process: through the sharded render over a local list of
  its prim line's shards, and through ``render``; with ``slow_save`` rank
  0's saves take that many seconds longer.
"""
import dataclasses
import os
import pickle
import random
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the loop's telemetry mirrors its scalars to TensorBoard when it imports,
# which here loads TensorFlow (about 17 s a process); the JSONL log the
# tests read does not need it
sys.modules["torch.utils.tensorboard"] = None

from datetime import timedelta  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu_torch import config as tcfg  # noqa: E402
from gsplat_tpu_torch.core.camera import CameraView  # noqa: E402
import gsplat_tpu_torch.parallel as par  # noqa: E402
from gsplat_tpu_torch.parallel import dp, mesh as mesh_lib  # noqa: E402
from gsplat_tpu_torch.models import gaussian_model as gm  # noqa: E402
from gsplat_tpu_torch.parallel import prim_shard, sharded  # noqa: E402
from gsplat_tpu_torch.parallel import tile_shard  # noqa: E402
from gsplat_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from gsplat_tpu_torch.train import densify as densify_lib  # noqa: E402
from gsplat_tpu_torch.train import loop as tloop  # noqa: E402
from gsplat_tpu_torch.train import trainer  # noqa: E402
from gsplat_tpu_torch.viewer import network_gui  # noqa: E402
from gsplat_tpu_torch.viewer.network_gui import NetworkGUI  # noqa: E402

TIMEOUT = timedelta(seconds=120)  # a collective waits no longer for a rank


def _items(state):
    return ckpt_lib.state_items(state)


def _inputs(job, r):
    cam = CameraView.from_numpy(job["cams"][r], device="cpu")
    return (cam, *(torch.tensor(a) for a in job["imgs"][r]),
            torch.tensor(job["bg"]))


def _step_kw(job):
    return dict(image_width=job["W"], image_height=job["H"],
                opt=tcfg.OptimizationConfig(),
                rcfg=tcfg.RasterizerConfig(**job["rcfg"]),
                spatial_lr_scale=1.0)


def _reference(job, state, n):
    """The batch's step in one process: each camera's loss and gradients,
    summed in rank order and divided by the batch; the stats summed and
    maxed; ``finish_train_step``."""
    kw = _step_kw(job)
    stepc = state.step + 1
    views = []
    for r in range(n):
        cam, gt, am, invd, dm, bg = _inputs(job, r)
        views.append(trainer.camera_loss_grads(
            state.gaussians, state.exposure, cam, gt, am, invd, dm, bg,
            stepc, image_width=kw["image_width"],
            image_height=kw["image_height"], opt=kw["opt"], rcfg=kw["rcfg"],
            antialiasing=False, train_test_exp=False, use_depth=False))

    def total(fn):
        acc = fn(views[0])
        for v in views[1:]:
            acc = acc + fn(v)
        return acc

    grads = {k: total(lambda v: v[4][k]) / n for k in views[0][4]}
    accum = total(lambda v: torch.where(
        v[3].radii > 0, torch.linalg.norm(v[6][:, :2], dim=-1), 0.0))
    radii = views[0][3].radii
    for v in views[1:]:
        radii = torch.maximum(radii, v[3].radii)
    st = state.stats
    stats = densify_lib.DensifyStats(
        xyz_gradient_accum=st.xyz_gradient_accum + accum,
        denom=st.denom + total(lambda v: (v[3].radii > 0).float()),
        max_radii2d=torch.maximum(st.max_radii2d, radii))
    new = trainer.finish_train_step(
        state, grads, total(lambda v: v[5]) / n, stats, stepc, None,
        opt=kw["opt"], spatial_lr_scale=1.0)
    return dict(state=_items(new), loss=float(total(lambda v: v[0]) / n))


def _mesh_2d():
    mesh = mesh_lib.make_mesh((("data", 2), ("prim", -1)))
    return mesh, par.RankParts(mesh, "prim")


def run_step(job, mesh, rank, n):
    row = rank
    if job.get("layout") == "2d":
        mesh2, parts = _mesh_2d()
        row = mesh2.coords["data"]
        if job.get("grow_to"):
            # the whole state grown, then this rank's rows: the JAX test's
            # grow_capacity + shard_state
            state = ckpt_lib.grow_capacity(trainer.state_from_numpy(
                job["state"], device="cpu"), job["grow_to"])
            state = sharded.shard_state(state, parts)
        else:
            cap = job["state"]["gaussians"]["xyz"].shape[0]
            state = trainer.state_from_numpy(
                job["state"], device="cpu",
                rows=sharded.own_rows(parts, cap))
        step = sharded.make_sharded_dp_train_step(mesh2, **_step_kw(job))
    else:
        state = trainer.state_from_numpy(job["state"], device="cpu")
        step = dp.make_dp_train_step(mesh, **_step_kw(job))
    new, aux = step(state, *_inputs(job, row))
    out = dict(state=_items(new), loss=float(aux.loss), l1=float(aux.l1),
               num_pairs=int(aux.num_pairs), overflow=int(aux.overflow),
               radii=aux.radii.numpy(),
               checksum=float(new.gaussians.xyz.abs().sum()))
    if job.get("reference") and rank == 0:
        out["reference"] = _reference(job, state, n)
    return out


def _scene(job):
    g = gm.from_numpy(job["g"], device="cpu")
    return g, CameraView.from_numpy(job["cam"], device="cpu"), \
        torch.tensor(job["bg"])


def _split_render(job, parts, g, cam, bg):
    rcfg = tcfg.RasterizerConfig(**job["rcfg"])
    if job["kind"] == "slab":
        img, inv, ovf = prim_shard.render_prim_sharded(
            g, cam, job["W"], job["H"], bg, rcfg, n_slabs=parts,
            m_cap=job.get("m_cap"))
    else:
        img, inv, _, ovf = tile_shard.render_tile_sharded(
            g, cam, job["W"], job["H"], bg, rcfg, n_bands=parts)
    return img, inv, ovf


def _xyz_grad(job, parts, g, cam, bg):
    xyz = g.xyz.detach().requires_grad_()
    img, _, _ = _split_render(job, parts, dataclasses.replace(g, xyz=xyz),
                              cam, bg)
    (img ** 2).sum().backward()
    return xyz.grad.numpy()


def run_split(job, n):
    """A slab or band render with one part per rank, and with the parts a
    local list in this process."""
    axis = "prim" if job["kind"] == "slab" else "tile"
    parts = par.RankParts(mesh_lib.make_mesh(((axis, -1),)), axis)
    g, cam, bg = _scene(job)
    out = {}
    for name, p in (("ranks", parts), ("local", n)):
        with torch.no_grad():
            img, inv, ovf = _split_render(job, p, g, cam, bg)
        out[name] = dict(image=img.numpy(), invdepth=inv.numpy(),
                         overflow=int(ovf))
        if job.get("grad"):
            out[name]["grad"] = _xyz_grad(job, p, g, cam, bg)
    if job.get("trap"):
        # the image gather's backward summing the parts' cotangents: every
        # rank's loss is the same, so every part's gradient comes D times
        keep = par._GatherSlice
        par._GatherSlice = par._GatherSum
        try:
            out["trap"] = _xyz_grad(job, parts, g, cam, bg)
        finally:
            par._GatherSlice = keep
    return out


def run_sharded(job, n):
    """make_sharded_render / make_sharded_train_step with one row shard per
    rank (this rank's rows only), and the same over a local list of the
    whole state in this process."""
    parts = par.RankParts(mesh_lib.make_mesh((("prim", -1),)), "prim")
    cam = CameraView.from_numpy(job["cam"], device="cpu")
    bg = torch.tensor(job["bg"])
    cap = job["state"]["gaussians"]["xyz"].shape[0]
    mine = trainer.state_from_numpy(job["state"], device="cpu",
                                    rows=sharded.own_rows(parts, cap))
    whole = trainer.state_from_numpy(job["state"], device="cpu")
    out = dict(rows=mine.gaussians.capacity)
    tr = job["transient"]
    if job["kind"] == "sharded_render":
        kw = dict(image_width=job["W"], image_height=job["H"],
                  cfg=tcfg.RasterizerConfig(**job["rcfg"]), transient=tr)
        with torch.no_grad():
            for name, p, st in (("ranks", parts, mine), ("local", n, whole)):
                o = sharded.make_sharded_render(p, **kw)(st.gaussians, cam,
                                                         bg)
                out[name] = dict(image=o.image.numpy(),
                                 invdepth=o.invdepth.numpy(),
                                 radii=o.radii.numpy(),
                                 num_pairs=int(o.num_pairs),
                                 overflow=int(o.overflow))
        return out
    imgs = [torch.tensor(a) for a in job["imgs"]]
    for name, p, st in (("ranks", parts, mine), ("local", n, whole)):
        step = sharded.make_sharded_train_step(p, transient=tr,
                                               **_step_kw(job))
        new, aux = step(st, cam, *imgs, bg)
        out[name] = dict(state=_items(new), loss=float(aux.loss),
                         overflow=int(aux.overflow),
                         num_pairs=int(aux.num_pairs),
                         checksum=float(p.psum_value(
                             [new.gaussians.xyz.abs().sum()])
                             if p is parts else new.gaussians.xyz.abs().sum()))
    return out


def run_collectives(rank):
    """psum / pmean / pmax of mixed dtypes over the axes of a 2 x 2 mesh
    of the 4 ranks: each axis's line of ranks is its own group."""
    mesh = mesh_lib.make_mesh((("data", 2), ("prim", -1)))
    vals = [torch.tensor([rank, 1.0]), torch.tensor(10 * rank)]
    out = dict(coords=mesh.coords)
    for axis in ("data", "prim"):
        out[axis] = [[t.tolist() for t in fn(vals, mesh, axis)]
                     for fn in (par.psum, par.pmean, par.pmax)]
        out[axis + "_dtypes"] = [str(t.dtype)
                                 for t in par.psum(vals, mesh, axis)]
    return out


def run_exchange(rank, n):
    """Each rank sends (j + 1, 2) values 10·rank + j to every other rank j
    and receives from each in the same call: with 2 ranks the peer it
    sends to is the one it receives from, as in the 2-rank ring."""
    batches = []
    batch = torch.distributed.batch_isend_irecv

    def record(ops):
        batches.append(sorted((op.op.__name__, op.peer) for op in ops))
        return batch(ops)

    torch.distributed.batch_isend_irecv = record
    try:
        peers = [j for j in range(n) if j != rank]
        got = par.exchange(
            [(j, torch.full((j + 1, 2), 10.0 * rank + j)) for j in peers],
            [(j, torch.empty(rank + 1, 2)) for j in peers], "cpu")
        parts = par.RankParts(mesh_lib.make_mesh((("prim", -1),)), "prim")
        ring = [x.tolist() for _, x in parts.ring(
            [torch.tensor([float(rank)])], parts.k)]
        none = par.exchange([], [], "cpu")
    finally:
        torch.distributed.batch_isend_irecv = batch
    return dict(got=[t.tolist() for t in got], ring=ring, none=none,
                batches=batches)


def run_loop(job, rank):
    model = job["model"]
    writes = []

    def audit(event, args):
        if event == "open":
            path, mode, flags = args
            writing = ((isinstance(mode, str) and any(c in mode
                                                      for c in "wax+"))
                       or (isinstance(flags, int)
                           and flags & (os.O_WRONLY | os.O_RDWR
                                        | os.O_CREAT)))
            if writing and str(path).startswith(model):
                writes.append(str(path))
        elif event in ("os.mkdir", "shutil.copyfile") and \
                str(args[0]).startswith(model):
            writes.append(str(args[0]))

    if rank > 0:
        sys.addaudithook(audit)   # stays for the process: the last job
    cams = []
    make_dp = dp.make_dp_train_step
    make_sharded = sharded.make_sharded_train_step

    def record(make):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def recorded(state, cam, *rest):
                cams.append(cam.world_view.numpy().copy())
                new, aux = step(state, cam, *rest)
                if len(cams) == job.get("nan_at"):
                    aux = aux._replace(loss=torch.tensor(float("nan")))
                return new, aux
            return recorded
        return wrapped

    noise = list(job.get("noise", []))
    densify = trainer.densify_step

    def densify_with(state, gen, *a, **kw):
        if noise:
            kw["noise"] = tuple(torch.tensor(x) for x in noise.pop(0))
        return densify(state, gen, *a, **kw)

    gui, polls = None, []
    if job.get("gui_port") and rank == 0:
        gui = NetworkGUI("127.0.0.1", job["gui_port"], device="cpu")
        deadline = time.monotonic() + 60
        while gui.conn is None and time.monotonic() < deadline:
            gui._try_connect()
            time.sleep(0.02)
        assert gui.conn is not None, "no viewer client"
        poll = gui.poll

        def timed_poll(state, scene, pipe, rcfg, bg, iteration, *a, **kw):
            t = time.monotonic()
            poll(state, scene, pipe, rcfg, bg, iteration, *a, **kw)
            polls.append((iteration, time.monotonic() - t))
        gui.poll = timed_poll
    ranked_bridge = (job.get("gui_port")
                     and job.get("train_kw", {}).get("shard_gaussians"))
    frames, render_request = [], network_gui.render_request
    if ranked_bridge:
        def recorded(state, req, rcfg, pipe, bg, device, **kw):
            image = render_request(state, req, rcfg, pipe, bg, device, **kw)
            frames.append(dict(
                req=req, rcfg=rcfg, pipe=pipe, bg=torch.as_tensor(bg).numpy(),
                rows={k: getattr(state.gaussians, k).numpy().copy()
                      for k in gm.TENSOR_FIELDS},
                sh=state.gaussians.active_sh_degree, image=image.numpy()))
            return image
        network_gui.render_request = recorded
    save = tloop.Scene.save

    def slow_save(self, *a, **kw):
        time.sleep(job["slow_save"])
        return save(self, *a, **kw)

    if job.get("slow_save") and rank == 0:
        tloop.Scene.save = slow_save
    dp.make_dp_train_step = record(make_dp)     # the 2-D step's too
    sharded.make_sharded_train_step = record(make_sharded)
    trainer.densify_step = densify_with
    out = dict(cams=cams, writes=writes, polls=polls)
    try:
        random.seed(0)
        _, state = tloop.train(
            tcfg.ModelConfig(model_path=model, **job["model_kw"]),
            tcfg.OptimizationConfig(**job["opt_kw"]),
            tcfg.PipelineConfig(debug="nan_at" in job),
            tcfg.RasterizerConfig(**job["rcfg_kw"]), *job["hooks"],
            quiet=True, device="cpu", network_gui_server=gui,
            **{"data_parallel": True, **job.get("train_kw", {})})
        out.update(state=_items(state), noise_left=len(noise))
        if ranked_bridge:
            out["frames"] = _bridge_frames(frames, job, rank)
    except FloatingPointError as e:
        if "nan_at" not in job:
            raise
        out["raised"] = str(e)
    finally:
        dp.make_dp_train_step = make_dp
        sharded.make_sharded_train_step = make_sharded
        trainer.densify_step = densify
        tloop.Scene.save = save
        network_gui.render_request = render_request
        if gui is not None:
            gui.close()
    return out


def _bridge_frames(frames, job, rank):
    """Rank 0: every bridge frame as the client got it (uint8), as the
    sharded render of the gathered state over a local list of rank 0's
    prim line's shards renders it (uint8) and as ``render`` does (uint8),
    with the request's python toggles; None elsewhere."""
    world = torch.distributed.get_world_size()
    every = [None] * world
    torch.distributed.all_gather_object(every, frames)
    if rank:
        return None
    n_prim = world // 2 if job["train_kw"].get("data_parallel") else world
    out = []
    for i, f in enumerate(every[0]):
        rows = [every[r][i]["rows"] for r in range(n_prim)]
        g = gm.from_numpy(dict(
            {k: np.concatenate([x[k] for x in rows])
             for k in gm.TENSOR_FIELDS}, active_sh_degree=f["sh"]),
            device="cpu")
        args = (SimpleNamespace(gaussians=g), f["req"], f["rcfg"], f["pipe"], torch.tensor(f["bg"]),
                "cpu")
        local = network_gui.render_request(
            *args, parts=n_prim,
            transient=job["train_kw"].get("shard_transient", "replicated"))
        single = network_gui.render_request(*args)
        out.append(dict(
            client=np.asarray(network_gui.frame_bytes(torch.tensor(
                f["image"]))), local=np.asarray(network_gui.frame_bytes(
                    local)), single=np.asarray(network_gui.frame_bytes(
                        single)), sh_python=f["req"].sh_python,
            rows=[len(x["xyz"]) for x in rows]))
    return out


def main():
    out_dir = sys.argv[1]
    timeout = (timedelta(seconds=float(sys.argv[2])) if len(sys.argv) > 2
               else TIMEOUT)
    torch.set_num_threads(1)
    assert mesh_lib.init_distributed(device="cpu", timeout=timeout)
    rank, n = mesh_lib.world()
    with open(os.path.join(out_dir, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    mesh = mesh_lib.make_mesh((("data", -1),))
    assert mesh.shape == {"data": n} and mesh.coords == {"data": rank}
    results = {}
    for name, job in jobs.items():
        kind = job["kind"]
        if kind == "step":
            results[name] = run_step(job, mesh, rank, n)
        elif kind == "collectives":
            results[name] = run_collectives(rank)
        elif kind == "exchange":
            results[name] = run_exchange(rank, n)
        elif kind in ("slab", "band"):
            results[name] = run_split(job, n)
        elif kind in ("sharded_render", "sharded_step"):
            results[name] = run_sharded(job, n)
        else:
            results[name] = run_loop(job, rank)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
