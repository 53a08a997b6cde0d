"""Training loop: RD-loss updates, the validation / early-stop protocol,
checkpoints, the done-marker contract.

Port of ``pcc_geo_cnn_v2_tpu/training.py``: Adam(1e-4) on the model and
Adam(1e-3) on the factorized prior's quantiles, the focal + mbpov
objective (plus the aux loss), validation every ``val_every`` steps on
the RD loss alone, best-val checkpoints, early stop, warm start, resume
from the latest checkpoint and a ``done`` marker that sweep scripts read.

Differences from the JAX package, each forced by the framework:

- Checkpoints are the port's own (orbax needs JAX): ``ckpt_<step>/``
  holding ``state.pt`` with the params (a state dict), the Adam state and
  the step, read with ``torch.load(weights_only=True)``.
  :func:`load_params` reads one, or a flax ``.msgpack.gz`` asset, into the
  flax layout the codec takes.
- A step's batch indices and noise come from a generator seeded by
  (seed, step), as JAX folds the step into its key, so a resumed run takes
  the same steps as an uninterrupted one. The numbers are torch's, not
  ``jax.random``'s.
- Precision is set explicitly: f32, no TF32, deterministic cuDNN
  algorithms (``codec.deterministic_convs``), as the JAX package trains
  in f32.
- :meth:`Trainer.fit_blocks` keeps the dataset on the device and samples
  batches with replacement, as the JAX scan loop, one step a Python
  iteration.
- Data parallelism (JAX: ``Trainer(mesh=)``, the batch sharded over a
  device mesh in one process) is one process a rank in a
  ``torch.distributed`` group (``Trainer(group=)``, ``parallel/mesh.py``).
  Each rank takes its rows of every global batch and of the global batch's
  noise, so a step does not depend on the world size. The loss JAX
  differentiates is the global batch's, and parts of it are no mean of
  per-rank losses (mbpov is a ratio of global sums), so averaging per-rank
  losses as ``DistributedDataParallel`` does would give another gradient:
  the occupied count is summed over the ranks before the loss, each rank's
  loss is its share of the global one (the aux loss, which depends on the
  parameters only, on rank 0 alone), and the gradients are summed over the
  ranks. Every rank then takes the same Adam step on the same parameters
  (broadcast from rank 0 at the start). The logs are the global batch's
  (numerators summed over the ranks). Only rank 0 writes checkpoints, the
  log and the ``done`` marker. As in JAX, :meth:`Trainer.fit_blocks` stays
  single-device.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import re
import shutil
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pcc_geo_cnn_v2_tpu_torch.codec import deterministic_convs, resolve_device
from pcc_geo_cnn_v2_tpu_torch.models.codec_models import CompressionModelV2
from pcc_geo_cnn_v2_tpu_torch.models.entropy import FactorizedPrior
from pcc_geo_cnn_v2_tpu_torch.models.transforms import Conv, ConvTranspose
from pcc_geo_cnn_v2_tpu_torch.ops.losses import (
    binary_classification_counts,
    binary_classification_from_counts,
    rd_loss,
)
from pcc_geo_cnn_v2_tpu_torch.ops.voxel import voxelize
from pcc_geo_cnn_v2_tpu_torch.parallel.mesh import shard_rows
from pcc_geo_cnn_v2_tpu_torch.weights import (
    load_asset_tree,
    params_from_jax,
    params_to_jax,
)

logger = logging.getLogger(__name__)

__all__ = ["TrainConfig", "Trainer", "init_params", "make_optimizer",
           "make_loss_fn", "draw_noise", "load_params", "read_checkpoint"]

_CKPT = re.compile(r"ckpt_(\d+)")
# logs that are sums over a batch's rows (each rank logs its share)
_SUMMED_LOGS = ("loss", "focal_loss", "mbpov", "mbpov_y", "mbpov_z")


@dataclasses.dataclass
class TrainConfig:
    lmbda: float = 1e-4
    alpha: float = 0.9
    gamma: float = 2.0
    lr: float = 1e-4
    aux_lr: float = 1e-3
    batch_size: int = 32
    block_size: int = 64
    max_steps: int = 100_000
    val_every: int = 500
    val_batches: int = 10
    early_stop_patience: int = 2000  # steps without val improvement
    log_every: int = 100
    keep_checkpoints: int = 2

# flax's truncated-normal variance scaling divides the stddev by the std of
# a unit normal truncated to [-2, 2], so that the draws have variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(model, generator):
    """Initialise ``model`` in place with flax's initial distributions,
    drawn from the CPU ``generator``: conv and transposed-conv kernels
    ``lecun_normal`` (a normal truncated to ±2 std with variance 1/fan_in,
    fan_in = cin·k³), biases 0, the factorized prior as
    :meth:`FactorizedPrior.reset_parameters`. Torch modules carry their
    shapes, so no example input (JAX's ``block_size``) is needed."""
    for module in model.modules():
        if isinstance(module, (Conv, ConvTranspose)):
            w = module.weight
            std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
            cpu = torch.empty(w.shape)
            nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(cpu)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, FactorizedPrior):
            module.reset_parameters(generator)
    return model


def make_optimizer(model, lr=1e-4, aux_lr=1e-3):
    """optax's ``multi_transform`` of two ``adam``s as one torch Adam with
    two groups: every parameter named ``quantiles`` (the factorized prior's
    tails and medians, moved by the aux loss) at ``aux_lr``, every other
    at ``lr`` (JAX ``training.py:64-71``, ``:91-98``)."""
    named = list(model.named_parameters())
    aux = [p for n, p in named if n.rsplit(".", 1)[-1] == "quantiles"]
    main = [p for n, p in named if n.rsplit(".", 1)[-1] != "quantiles"]
    return torch.optim.Adam([{"params": main, "lr": lr},
                             {"params": aux, "lr": aux_lr}],
                            betas=(0.9, 0.999), eps=1e-8)


def draw_noise(model, n, block_size, generator):
    """U(-0.5, 0.5) training noise for ``n`` blocks, NDHWC on the
    generator's device: ``noise_y`` on y (x/8), and for a hyperprior model
    ``noise_z`` on z (x/16)."""
    c = model.num_filters
    shapes = {"noise_y": (n,) + (-(-block_size // 8),) * 3 + (c,)}
    if isinstance(model, CompressionModelV2):
        shapes["noise_z"] = (n,) + (-(-block_size // 16),) * 3 + (c,)
    return {k: torch.rand(s, generator=generator, device=generator.device)
            - 0.5 for k, s in shapes.items()}


def make_loss_fn(model, config, group=None):
    """``(points [N, P, 3] int, noise) -> (loss + aux, logs)``: voxelize,
    the training graph, the RD loss, the aux loss (JAX
    ``training.py:101-120``). ``logs["loss"]`` is the RD loss alone.

    With a data-parallel ``group``, ``points`` and ``noise`` are this
    rank's rows of a global batch: the occupied count is summed over the
    ranks first, and the loss returned is this rank's share of the global
    loss (its focal sum, its Σ log p over the global count, and the aux
    loss on rank 0 only), so that the ranks' gradients sum to the global
    batch's. The logs are the global batch's."""
    is_v2 = isinstance(model, CompressionModelV2)

    def loss_fn(points, noise):
        x = voxelize(points, config.block_size)
        out = model(x, training=True, **noise)
        liks = [out["y_likelihoods"]]
        if is_v2:
            liks.append(out["z_likelihoods"])
        num_occupied = None
        if group is not None:
            num_occupied = torch.sum(x)
            dist.all_reduce(num_occupied, group=group)
        loss, logs = rd_loss(x, out["x_tilde"], liks, config.lmbda,
                             gamma=config.gamma, alpha=config.alpha,
                             num_occupied=num_occupied)
        aux = model.aux_loss()
        logs["aux_loss"] = aux
        logs = {k: v.detach() for k, v in logs.items()}
        if group is None:
            return loss + aux, logs
        logs.update(_global_logs(
            logs, binary_classification_counts(x, out["x_tilde"]), group))
        return (loss + aux if dist.get_rank(group) == 0 else loss), logs

    return loss_fn


def _global_logs(logs, counts, group):
    """The global batch's logs from the ranks' shares: the summed logs and
    the classification counts added over the ranks (in f64), the
    classification ratios taken from the sums."""
    keys = [k for k in _SUMMED_LOGS if k in logs]
    flat = torch.cat([torch.stack([logs[k] for k in keys]), counts]).double()
    dist.all_reduce(flat, group=group)
    out = {k: v.float() for k, v in zip(keys, flat)}
    out.update(binary_classification_from_counts(flat[len(keys):].float()))
    return out


def _checkpoints(directory):
    found = [(int(m.group(1)), p) for p in Path(directory).glob("ckpt_*")
             if (m := _CKPT.fullmatch(p.name))]
    return [p for _, p in sorted(found)]


def read_checkpoint(path):
    """A ``ckpt_<step>/`` directory → dict(params, opt_state, step), on the
    CPU."""
    return torch.load(Path(path) / "state.pt", map_location="cpu",
                      weights_only=True)


def load_params(path):
    """Weights in the flax layout (``{"params": ...}``, numpy leaves) from
    a ``.msgpack.gz`` asset or from the latest ``ckpt_<step>`` of a
    training directory."""
    path = Path(path)
    if not path.is_dir():
        return load_asset_tree(path)
    latest = Trainer.latest_checkpoint(path)
    if latest is None:
        raise FileNotFoundError(f"no ckpt_<step> in {path}")
    return params_to_jax(read_checkpoint(latest)["params"])


class Trainer:
    """Runs the training protocol over block datasets on one device, or as
    one rank of a data-parallel group (module docstring).

    :param model: a port model (``models.configs.build_model``); its
        parameters are initialised here (:func:`init_params` from ``seed``),
        then restored from the latest checkpoint of ``checkpoint_dir`` or,
        when there is none, taken from ``warm_start`` (a training directory
        or a ``.msgpack.gz`` asset; params only).
    :param device: the card unless ``"cpu"`` is asked for (a rank's own,
        ``parallel.mesh.process_group``).
    :param group: a ``torch.distributed`` process group of data-parallel
        ranks, each running this trainer with the same arguments and
        batches: :meth:`fit` then trains on the global batches.
    """

    def __init__(self, model, config: TrainConfig, checkpoint_dir, seed=42,
                 warm_start=None, device=None, group=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            deterministic_convs()
        self.config, self.seed = config, seed
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.model = init_params(model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).train()
        self.opt = make_optimizer(self.model, config.lr, config.aux_lr)
        self.loss_fn = make_loss_fn(self.model, config, group)
        self.dir = Path(checkpoint_dir).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.dir / "train_log.jsonl"
        self.start_step = 0
        latest = self.latest_checkpoint(self.dir)
        if latest is not None:
            self.restore(latest)
            logger.info("resumed from %s (step %d)", latest, self.start_step)
        elif warm_start:
            self.model.load_state_dict(params_from_jax(
                load_params(warm_start)))
            logger.info("warm start from %s", warm_start)
        if group is not None:
            with torch.no_grad():
                src = dist.get_global_rank(group, 0)
                for t in self.model.state_dict().values():
                    dist.broadcast(t, src=src, group=group)

    # -- checkpoint protocol ------------------------------------------------

    @staticmethod
    def latest_checkpoint(directory):
        ckpts = _checkpoints(directory)
        return ckpts[-1] if ckpts else None

    def save(self, step):
        """Write ``ckpt_<step>`` (through a temporary directory, renamed
        when complete) and keep the newest ``keep_checkpoints``; in a group
        rank 0 alone writes."""
        path = self.dir / f"ckpt_{step}"
        if self.rank:
            return path
        tmp = self.dir / f"ckpt_{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"params": self.model.state_dict(),
                    "opt_state": self.opt.state_dict(), "step": step},
                   tmp / "state.pt")
        shutil.rmtree(path, ignore_errors=True)
        tmp.rename(path)
        for old in _checkpoints(self.dir)[: -self.config.keep_checkpoints]:
            shutil.rmtree(old)
        return path

    def restore(self, path, params_only=False):
        # read on the CPU: the loads copy to the parameters' device, and
        # Adam's step counts stay CPU tensors, as a fresh Adam keeps them
        state = read_checkpoint(path)
        self.model.load_state_dict(state["params"])
        if not params_only:
            self.opt.load_state_dict(state["opt_state"])
            self.start_step = int(state["step"])

    # -- steps ----------------------------------------------------------------

    def _generator(self, *key):
        """A generator on the device seeded by (seed, *key): 0 and the step
        for a training step, 1, the step and the batch for validation."""
        state = np.random.SeedSequence((self.seed,) + key).generate_state(2)
        seed = (int(state[0]) << 31) ^ int(state[1])
        return torch.Generator(device=self.device).manual_seed(seed)

    def _update(self, points, noise):
        """One Adam step on this rank's rows ``points`` and ``noise``."""
        self.opt.zero_grad(set_to_none=True)
        total, logs = self.loss_fn(points, noise)
        total.backward()
        if self.group is not None:
            self._sum_gradients()
        self.opt.step()
        return logs

    def _sum_gradients(self):
        """All-reduce the gradients as a sum, in one flat buffer: the
        ranks' losses are shares of the global loss, so the sum is the
        global batch's gradient, the same on every rank. A parameter
        without a gradient on this rank (the quantiles, which only the aux
        loss of rank 0 moves) adds zeros."""
        params = list(self.model.parameters())
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                          .reshape(-1) for p in params])
        dist.all_reduce(flat, group=self.group)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p)

    def _rows(self, batch):
        """This rank's rows of a global batch (all of it without a
        group); a batch the world size does not divide raises."""
        if self.group is None:
            return batch
        return shard_rows(batch, self.rank, self.world)

    def _global_noise(self, n, generator):
        """This rank's rows of the noise of an ``n``-block global batch."""
        return {k: self._rows(v) for k, v in draw_noise(
            self.model, n, self.config.block_size, generator).items()}

    def step_batch(self, points, step):
        """One update on a host batch ``[N, P, 3]`` (the feed loop); in a
        group, the global batch, of which this rank takes its rows."""
        noise = self._global_noise(len(points), self._generator(0, step))
        return self._update(torch.as_tensor(self._rows(points),
                                            device=self.device), noise)

    def step_blocks(self, data, step):
        """One update on ``batch_size`` blocks drawn with replacement from
        the device-resident ``data`` (:meth:`device_data`)."""
        g = self._generator(0, step)
        idx = torch.randint(0, len(data), (self.config.batch_size,),
                            generator=g, device=self.device)
        return self._update(data[idx].to(torch.int32),
                            self._global_noise(len(idx), g))

    @torch.no_grad()
    def eval_batch(self, points, step, i):
        """Logs of the loss on a host batch (in a group, the global batch),
        no update (``logs["loss"]`` is the RD loss without aux)."""
        noise = self._global_noise(len(points), self._generator(1, step, i))
        return self.loss_fn(torch.as_tensor(self._rows(points),
                                            device=self.device), noise)[1]

    @torch.no_grad()
    def val_loss_blocks(self, data, step):
        """Mean RD loss (without aux) over ``min(len // batch, val_batches)``
        (at least 1) batches covering the device-resident val set in order
        (JAX ``make_scan_val_step``)."""
        cfg = self.config
        n = len(data)
        n_batches = min(max(n // cfg.batch_size, 1), cfg.val_batches)
        total = 0.0
        for i in range(n_batches):
            idx = (torch.arange(cfg.batch_size, device=self.device)
                   + i * cfg.batch_size) % n
            pts = data[idx].to(torch.int32)
            total += float(self.loss_fn(pts, draw_noise(
                self.model, cfg.batch_size, cfg.block_size,
                self._generator(1, step, i)))[1]["loss"])
        return total / n_batches

    def device_data(self, ds):
        """A ``BlockDataset`` packed once and put on the device as int8
        (int16 above 128³ blocks)."""
        arr = ds._pack(np.arange(len(ds)))
        dtype = np.int8 if self.config.block_size <= 128 else np.int16
        return torch.as_tensor(arr.astype(dtype), device=self.device)

    # -- loops ----------------------------------------------------------------

    def _log(self, step, split, logs, extra=None):
        if self.rank:
            return
        rec = {"step": step, "split": split,
               **{k: float(v) for k, v in logs.items()}}
        if extra:
            rec.update(extra)
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _log_train(self, step, logs, t0):
        """Log a training step; the rate counts ``log_every`` steps since
        ``t0`` up to this step's logs on the host (reading them waits for
        the device). Returns the new ``t0``."""
        logs = {k: float(v) for k, v in logs.items()}
        self._log(step, "train", logs, {
            "steps_per_sec": self.config.log_every / (time.time() - t0)})
        return time.time()

    def _validate(self, step, val_loss, best):
        """Log ``val_loss``; save on improvement. ``best`` = [loss, step];
        returns True when early stopping."""
        self._log(step, "val", {"loss": val_loss})
        logger.info("step %d val loss %.4f (best %.4f)", step, val_loss,
                    best[0])
        if val_loss < best[0]:
            best[:] = [val_loss, step]
            self.save(step)
        elif step - best[1] >= self.config.early_stop_patience:
            logger.info("early stop at %d (best %d)", step, best[1])
            return True
        return False

    def _finish(self, step, best):
        if self.rank == 0:
            if self.latest_checkpoint(self.dir) is None:
                self.save(step)
            (self.dir / "done").touch()
        if self.group is not None:
            dist.barrier(group=self.group)  # the files exist on every return
        return best[0]

    def fit(self, train_batches, val_batches_fn):
        """Train until max_steps or early stop on host-fed batches; returns
        the best val loss (None when the done marker exists).

        :param train_batches: infinite iterator of [N, P, 3] int batches;
            in a group every rank's iterator yields the same global
            batches.
        :param val_batches_fn: callable returning an iterator of val
            batches (global batches in a group).
        """
        cfg = self.config
        if (self.dir / "done").exists():
            logger.info("done marker exists, skipping training")
            return None
        best = [np.inf, self.start_step]
        step = self.start_step
        t0 = time.time()
        while step < cfg.max_steps:
            step += 1
            logs = self.step_batch(next(train_batches), step)
            # always log the first step so short runs still produce curves
            if step % cfg.log_every == 0 or step == self.start_step + 1:
                t0 = self._log_train(step, logs, t0)
            if step % cfg.val_every == 0:
                losses = [float(self.eval_batch(vb, step, i)["loss"])
                          for i, vb in zip(range(cfg.val_batches),
                                           val_batches_fn())]
                if not losses:
                    raise ValueError("validation produced zero batches")
                if self._validate(step, float(np.mean(losses)), best):
                    break
        return self._finish(step, best)

    def fit_blocks(self, train_ds, val_ds):
        """The same protocol over device-resident block datasets
        (``utils.data.BlockDataset``): packed once, uploaded as int8 /
        int16, batches sampled on the device with replacement (JAX
        ``fit_blocks``; not step-for-step comparable with :meth:`fit`).
        Single-device, as in JAX."""
        if self.group is not None:
            raise ValueError("fit_blocks is single-device; use fit() in a "
                             "data-parallel group")
        cfg = self.config
        if (self.dir / "done").exists():
            logger.info("done marker exists, skipping training")
            return None
        data, val_data = self.device_data(train_ds), self.device_data(val_ds)
        best = [np.inf, self.start_step]
        step = self.start_step
        t0 = time.time()
        while step < cfg.max_steps:
            step += 1
            logs = self.step_blocks(data, step)
            if step % cfg.log_every == 0:
                t0 = self._log_train(step, logs, t0)
            if step % cfg.val_every == 0 and self._validate(
                    step, self.val_loss_blocks(val_data, step), best):
                break
        return self._finish(step, best)
