"""Driver ``train``: the program's trainer (``training.Trainer``) on the
blocks of the mix's clouds, held on the device as int8, stepped in a
closed loop of ``Trainer.step_blocks`` as ``fit_blocks`` drives it (a
batch drawn on the device each step). End-to-end: ``train_rate``, the
blocks stepped in the window over its wall seconds.

Set-up makes the initial weights on the device from the seed, loads them
into the trainer, and takes its first three steps through the window's own
call; the window then goes on from step 4 with the same object. Judged
after the window against the plain reference, which takes the same initial
weights, rows and noise through three steps of its own: each step's loss,
the norm of the first gradient (from Adam's first moment after one step)
and the norm of the parameters' change after three steps, both by the
worst leaf.
"""

from __future__ import annotations

import time

import numpy as np

from benchlib import codec_cells as cc
from benchlib import weights
from benchlib.core import ROOT
from benchlib.init_weights import init_tree
from reference.judge import octree_blocks

KIND = "train"
CHECKED_STEPS = 3
BETA1 = 0.9


def _flax_name(name):
    """A parameter of the program's modules → its leaf in the weight
    tree."""
    return name.replace(".", "/").replace("/weight", "/kernel")


def _blocks(run):
    c = run.mix["clouds"]
    out = []
    for pts in cc.make_pool(run):
        out += octree_blocks(pts, c["resolution"], c["level"])[1]
    return out


def _rows(blocks, device):
    """Blocks as a [n, max points, 3] int8 tensor padded with -1."""
    import torch

    rows = np.full((len(blocks), max(len(b) for b in blocks), 3), -1,
                   np.int8)
    for i, b in enumerate(blocks):
        rows[i, :len(b)] = b
    return torch.as_tensor(rows, device=device)


def _host(leaves):
    return {k: v.cpu().numpy() for k, v in leaves.items()}


def _host_tree(tree):
    return {k: _host_tree(v) if isinstance(v, dict) else
            v.detach().cpu().numpy() for k, v in tree.items()}


def prepare(run, carry=None):
    import torch

    from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs
    from pcc_geo_cnn_v2_tpu_torch.models.configs import build_model
    from pcc_geo_cnn_v2_tpu_torch.training import TrainConfig, Trainer
    from pcc_geo_cnn_v2_tpu_torch.utils.data import BlockDataset
    from pcc_geo_cnn_v2_tpu_torch.weights import params_from_jax

    cfg, mix = run.config, run.mix
    if torch.device(run.device).type == "cuda":
        deterministic_convs()
    tree0 = _host_tree(init_tree(weights.load_tree(ROOT / cfg["weights"]),
                                 run.seed, run.device))
    blocks = _blocks(run)
    tc = TrainConfig(lmbda=mix["lambda"], alpha=cfg["focal_alpha"],
                     batch_size=mix["batch"], block_size=cfg["block_size"])
    trainer = Trainer(build_model(cfg["model"]), tc,
                      run.cache_dir / "train" / str(run.seed),
                      seed=run.seed, device=run.device)
    trainer.model.load_state_dict(params_from_jax(tree0))
    data = trainer.device_data(BlockDataset(blocks))
    params = dict(trainer.model.named_parameters())
    theta0 = {_flax_name(n): p.detach().clone() for n, p in params.items()}
    losses, grads = [], None
    for step in range(1, CHECKED_STEPS + 1):
        with run.span("step"):
            losses.append(float(trainer.step_blocks(data, step)["loss"]))
        if step == 1:
            st = trainer.opt.state
            grads = {_flax_name(n): (st[p]["exp_avg"] / (1 - BETA1)).clone()
                     for n, p in params.items() if p in st}
    change = {_flax_name(n): (p.detach() - theta0[_flax_name(n)])
              for n, p in params.items()}
    return {"trainer": trainer, "data": data, "step": CHECKED_STEPS,
            "tree0": tree0, "blocks": blocks,
            "answers": {"loss": losses, "grad": _host(grads),
                        "change": _host(change)}}


def measure(run, state):
    import torch

    trainer, data = state["trainer"], state["data"]
    batch = run.mix["batch"]
    records = []
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    while time.perf_counter() < deadline:
        state["step"] += 1
        t = time.perf_counter()
        with run.span("step"):
            trainer.step_blocks(data, state["step"])
        records.append({"i": state["step"], "t0": t, "out": True})
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize(run.device)
    window = time.perf_counter() - t0
    blocks = batch * len(records)
    return {"records": records, "window_s": window,
            "metrics": {"train_rate": (blocks / window, "blocks/s")},
            "work": {"requests": len(records), "blocks": blocks,
                     "points": 0}}


def collect(run, state, result):
    result["answers"] = state["answers"]


def release(run, state):
    for key in ("trainer", "data"):
        state.pop(key, None)
    cc.free_device(run.device)


def reference_steps(run, state, tf32=False):
    """The plain reference's three steps from the same weights, rows and
    noise: (losses, first gradient, change after three steps), by leaf."""
    import torch

    from reference.model import f32_convs, tensor_tree
    from reference.train import TrainReference, step_draws

    cfg, mix = run.config, run.mix
    if torch.device(run.device).type == "cuda":
        f32_convs(tf32)
    ref = TrainReference(tensor_tree(state["tree0"], run.device),
                         cfg["analysis"], mix["lambda"], cfg["focal_alpha"],
                         mix["gamma"], mix["lr"], mix["aux_lr"])
    theta0 = {k: p.detach().clone() for k, p in ref.params.items()}
    rows = _rows(state["blocks"], run.device)
    B = cfg["block_size"]
    losses, first = [], None
    for step in range(1, CHECKED_STEPS + 1):
        idx, ny, nz = step_draws(run.seed, step, len(rows), mix["batch"], B,
                                 cfg["num_filters"], run.device)
        pts = rows[idx].long()
        x = torch.zeros(len(idx), 1, B, B, B, device=run.device)
        n, p = torch.nonzero(pts[..., 0] >= 0, as_tuple=True)
        x[n, 0, pts[n, p, 0], pts[n, p, 1], pts[n, p, 2]] = 1.0
        loss, grads = ref.step(x, ny, nz)
        losses.append(loss)
        if step == 1:
            first = {k: v.cpu().numpy() for k, v in grads.items()}
    change = {k: (p.detach() - theta0[k]).cpu().numpy()
              for k, p in ref.params.items()}
    if torch.device(run.device).type == "cuda":
        f32_convs(False)
    return {"loss": losses, "grad": first, "change": change}


def numbers(ref, ans):
    """loss_gap: the worst step's |loss - reference| / |reference|;
    grad_gap and change_gap: the worst leaf's gap between the two norms
    over the larger of the reference's norm of that leaf and of the median
    leaf. The change leaves exclude those whose reference gradient is under
    a thousandth of the median leaf's (round-off moves them under Adam)."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(ans["loss"], ref["loss"]))
    g_ref = {k: float(np.linalg.norm(v)) for k, v in ref["grad"].items()}
    g_med = float(np.median(list(g_ref.values())))

    def worst(key, keys):
        r = {k: float(np.linalg.norm(ref[key][k])) for k in keys}
        med = float(np.median(list(r.values())))
        return max(abs(float(np.linalg.norm(ans[key].get(
            k, np.zeros(1)))) - r[k]) / max(r[k], med) for k in keys)

    moved = [k for k in ref["change"] if g_ref[k] >= 1e-3 * g_med]
    return {"loss_gap": loss, "grad_gap": worst("grad", list(ref["grad"])),
            "change_gap": worst("change", moved)}


def judge(run, state, result):
    return numbers(reference_steps(run, state), result["answers"])


def control(run, state, result):
    """The reference with TF32 convolutions in the program's place."""
    low = reference_steps(run, state, tf32=True)
    return numbers(reference_steps(run, state), low)


def _half_batch():
    """The fault of a step that leaves out half of its batch and takes its
    loss over the rest."""
    from pcc_geo_cnn_v2_tpu_torch.training import Trainer

    real = Trainer._update

    def half(self, points, noise):
        n = len(points) // 2
        return real(self, points[:n], {k: v[:n] for k, v in noise.items()})

    Trainer._update = half
    return lambda: setattr(Trainer, "_update", real)


def _unchanged():
    """The fault of a step that returns its state unchanged: Adam's update
    is skipped."""
    from pcc_geo_cnn_v2_tpu_torch.training import Trainer

    real = Trainer._update

    def frozen(self, points, noise):
        step = self.opt.step
        self.opt.step = lambda *a, **k: None
        try:
            return real(self, points, noise)
        finally:
            self.opt.step = step

    Trainer._update = frozen
    return lambda: setattr(Trainer, "_update", real)


# faults planted in the program for the check's upper readings and tests:
# name → plant(), which returns the undo
FAULTS = {"half_batch": _half_batch, "unchanged": _unchanged}
