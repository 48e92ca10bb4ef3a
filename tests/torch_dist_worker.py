"""One rank of a gloo process group on the CPU, for tests/test_torch_dp.py:
the counterpart of tests/multihost_worker.py for the port. It imports no
JAX, as a rank of the port on a machine without JAX would not.

Run by the test as:
    MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> WORLD_SIZE=<n> RANK=<r> \\
    LOCAL_RANK=<r> python tests/torch_dist_worker.py <dir> [<timeout s>]

``<dir>/jobs.pkl`` holds the jobs, made by the test from numpy-seeded
inputs (the same arrays it hands the JAX package). The rank joins the group
with ``init_distributed(device="cpu")`` (a collective timeout of
``<timeout s>``, by default ``TIMEOUT``), runs every job and writes what it
got to ``<dir>/rank<r>.pkl``. A job:

- ``step``: one ``make_dp_train_step`` (or, with ``n_shards``,
  ``make_sharded_dp_train_step``) step from the job's state on this rank's
  camera and images; with ``reference`` rank 0 also computes, in this
  process, the batch's step from every camera's ``camera_loss_grads``
  (gradients summed in rank order and halved, stats summed and maxed,
  ``finish_train_step``);
- ``collectives``: ``psum``, ``pmean`` and ``pmax`` over both axes of a
  2 x 2 mesh of the ranks;
- ``loop``: ``train(..., data_parallel=True)`` on a COLMAP scene, with the
  densify draws handed in, recording the camera of every step and every
  file this rank opens for writing or directory it makes; with ``nan_at``
  the loss of that step is made NaN under ``--debug``, and the loop's
  ``FloatingPointError`` is the job's result; with ``gui_port`` rank 0
  binds the SIBR bridge there, waits for the test's client before it
  trains, and records how long each poll held it; with ``slow_save`` rank
  0's saves take that many seconds longer.
"""
import os
import pickle
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the loop's telemetry mirrors its scalars to TensorBoard when it imports,
# which here loads TensorFlow (about 17 s a process); the JSONL log the
# tests read does not need it
sys.modules["torch.utils.tensorboard"] = None

from datetime import timedelta  # noqa: E402

import torch  # noqa: E402

from gsplat_tpu_torch import config as tcfg  # noqa: E402
from gsplat_tpu_torch.core.camera import CameraView  # noqa: E402
import gsplat_tpu_torch.parallel as par  # noqa: E402
from gsplat_tpu_torch.parallel import dp, mesh as mesh_lib  # noqa: E402
from gsplat_tpu_torch.parallel import sharded  # noqa: E402
from gsplat_tpu_torch.train import checkpoint as ckpt_lib  # noqa: E402
from gsplat_tpu_torch.train import densify as densify_lib  # noqa: E402
from gsplat_tpu_torch.train import loop as tloop  # noqa: E402
from gsplat_tpu_torch.train import trainer  # noqa: E402
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


def run_step(job, mesh, rank, n):
    state = trainer.state_from_numpy(job["state"], device="cpu")
    if job.get("grow_to"):
        state = ckpt_lib.grow_capacity(state, job["grow_to"])
    if job.get("n_shards"):
        state = sharded.shard_state(state, job["n_shards"])
        step = sharded.make_sharded_dp_train_step(
            mesh, job["n_shards"], transient=job.get("transient",
                                                     "replicated"),
            **_step_kw(job))
    else:
        step = dp.make_dp_train_step(mesh, **_step_kw(job))
    new, aux = step(state, *_inputs(job, rank))
    out = dict(state=_items(new), loss=float(aux.loss), l1=float(aux.l1),
               num_pairs=int(aux.num_pairs), overflow=int(aux.overflow),
               radii=aux.radii.numpy(),
               checksum=float(new.gaussians.xyz.abs().sum()))
    if job.get("reference") and rank == 0:
        out["reference"] = _reference(job, state, n)
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

        def timed_poll(state, scene, pipe, rcfg, bg, iteration, *a):
            t = time.monotonic()
            poll(state, scene, pipe, rcfg, bg, iteration, *a)
            polls.append((iteration, time.monotonic() - t))
        gui.poll = timed_poll
    save = tloop.Scene.save

    def slow_save(self, *a, **kw):
        time.sleep(job["slow_save"])
        return save(self, *a, **kw)

    if job.get("slow_save") and rank == 0:
        tloop.Scene.save = slow_save
    dp.make_dp_train_step = record(make_dp)     # the 2-D step's too
    trainer.densify_step = densify_with
    out = dict(cams=cams, writes=writes, polls=polls)
    try:
        random.seed(0)
        _, state = tloop.train(
            tcfg.ModelConfig(model_path=model, **job["model_kw"]),
            tcfg.OptimizationConfig(**job["opt_kw"]),
            tcfg.PipelineConfig(debug="nan_at" in job),
            tcfg.RasterizerConfig(**job["rcfg_kw"]), *job["hooks"],
            quiet=True, data_parallel=True, device="cpu",
            network_gui_server=gui, **job.get("train_kw", {}))
        out.update(state=_items(state), noise_left=len(noise))
    except FloatingPointError as e:
        if "nan_at" not in job:
            raise
        out["raised"] = str(e)
    finally:
        dp.make_dp_train_step = make_dp
        trainer.densify_step = densify
        tloop.Scene.save = save
        if gui is not None:
            gui.close()
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
        if job["kind"] == "step":
            results[name] = run_step(job, mesh, rank, n)
        elif job["kind"] == "collectives":
            results[name] = run_collectives(rank)
        else:
            results[name] = run_loop(job, rank)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
