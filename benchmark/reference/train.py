"""Plain PyTorch reference of the codec's training step (arXiv:2006.09043,
with the entropy models of Ballé et al., arXiv:1802.01436): the forward
with uniform noise in place of rounding, the factorized prior's and the
Gaussian's likelihoods, the loss λ·focal + bits per occupied voxel of y and
z, the factorized prior's auxiliary loss on its quantiles, and Adam.

The lower bounds on likelihoods and scales pass a gradient wherever it
would raise the bounded value (tensorflow-compression's ``lower_bound``).
Float32 with TF32 off; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import Transforms

__all__ = ["step_draws", "TrainReference", "LIKELIHOOD_BOUND", "SCALE_MIN"]

LIKELIHOOD_BOUND = 1e-9
SCALE_MIN = 0.11
TAIL_MASS = 1e-9


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, 0.0), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, bound)


def step_draws(seed, step, n_rows, batch, block, filters, device):
    """A step's rows and noise as the training feed draws them: a device
    generator seeded from (seed, 0, step), rows uniform with replacement,
    then U(-0.5, 0.5) noise for y (block / 8) and z (block / 16), NDHWC."""
    state = np.random.SeedSequence((seed, 0, step)).generate_state(2)
    g = torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))
    idx = torch.randint(0, n_rows, (batch,), generator=g, device=device)
    ny = torch.rand((batch,) + (block // 8,) * 3 + (filters,), generator=g,
                    device=device) - 0.5
    nz = torch.rand((batch,) + (block // 16,) * 3 + (filters,),
                    generator=g, device=device) - 0.5
    return idx, ny, nz


def _logits_cumulative(eb, x, detach=False):
    """The factorized prior's cumulative logit at x [C, 1, M]."""
    sg = (lambda t: t.detach()) if detach else (lambda t: t)
    u = x
    n = sum(1 for k in eb if k.startswith("matrix_"))
    for k in range(n):
        u = torch.matmul(F.softplus(sg(eb[f"matrix_{k}"])), u) \
            + sg(eb[f"bias_{k}"])
        if f"factor_{k}" in eb:
            u = u + torch.tanh(sg(eb[f"factor_{k}"])) * torch.tanh(u)
    return u


def _phi(x):
    return 0.5 * torch.special.erfc(-x / math.sqrt(2.0))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class TrainReference:
    """The training step over a flax weight tree of leaf tensors that it
    owns (``params``), with its own Adam: the quantiles at ``aux_lr``,
    every other leaf at ``lr``."""

    def __init__(self, tree, analysis, lmbda, alpha, gamma, lr, aux_lr):
        self.params = _leaves(tree)
        for p in self.params.values():
            p.requires_grad_(True)
        self.tree = _tree(self.params)
        self.t = Transforms(self.tree, analysis)
        self.lmbda, self.alpha, self.gamma = lmbda, alpha, gamma
        aux = [p for k, p in self.params.items() if k.endswith("quantiles")]
        main = [p for k, p in self.params.items()
                if not k.endswith("quantiles")]
        self.opt = torch.optim.Adam([{"params": main, "lr": lr},
                                     {"params": aux, "lr": aux_lr}],
                                    betas=(0.9, 0.999), eps=1e-8)

    def loss(self, x, noise_y, noise_z):
        """(RD loss, aux loss) of occupancy x [N, 1, B, B, B]; noises
        NDHWC."""
        eb = self.tree["entropy_bottleneck"]
        y = self.t.analysis_t(x)
        z = self.t.hyper_analysis_t(y)
        z_tilde = z + noise_z.permute(0, 4, 1, 2, 3)
        c = z_tilde.shape[1]
        flat = z_tilde.transpose(0, 1).reshape(c, 1, -1)
        lo = _logits_cumulative(eb, flat - 0.5)
        hi = _logits_cumulative(eb, flat + 0.5)
        sign = -torch.sign(lo + hi).detach()
        z_lik = lower_bound(torch.abs(torch.sigmoid(sign * hi)
                                      - torch.sigmoid(sign * lo)),
                            LIKELIHOOD_BOUND)
        sigma = lower_bound(self.t.hyper_synthesis_t(z_tilde), SCALE_MIN)
        y_tilde = y + noise_y.permute(0, 4, 1, 2, 3)
        v = torch.abs(y_tilde)
        y_lik = lower_bound(_phi((0.5 - v) / sigma) - _phi((-0.5 - v) / sigma),
                            LIKELIHOOD_BOUND)
        x_tilde = self.t.synthesis_t(y_tilde)
        a, g = self.alpha, self.gamma
        pt_1 = _clip(torch.where(x == 1, x_tilde, 1.0), 1e-3, 0.999)
        pt_0 = _clip(torch.where(x == 0, x_tilde, 0.0), 1e-3, 0.999)
        focal = (-torch.sum(a * (1 - pt_1) ** g * torch.log(pt_1))
                 - torch.sum((1 - a) * pt_0 ** g * torch.log(1 - pt_0)))
        occupied = torch.sum(x)
        bits = (torch.sum(torch.log(y_lik)) + torch.sum(torch.log(z_lik))) \
            / (-math.log(2) * occupied)
        t = TAIL_MASS
        targets = torch.log(torch.tensor([t / 2, 0.5, 1 - t / 2])
                            / torch.tensor([1 - t / 2, 0.5, t / 2]))
        targets = targets.to(x.device)
        q = _logits_cumulative(eb, eb["quantiles"][:, None, :], detach=True)
        aux = torch.sum(torch.abs(q[:, 0, :] - targets))
        return self.lmbda * focal + bits, aux

    def step(self, x, noise_y, noise_z):
        """One Adam step; returns (RD loss, {leaf: gradient})."""
        self.opt.zero_grad(set_to_none=True)
        loss, aux = self.loss(x, noise_y, noise_z)
        (loss + aux).backward()
        grads = {k: p.grad.detach().clone() for k, p in self.params.items()}
        self.opt.step()
        return float(loss.detach()), grads


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tree(leaves):
    out = {}
    for path, v in leaves.items():
        *mods, name = path.split("/")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = v
    return out
