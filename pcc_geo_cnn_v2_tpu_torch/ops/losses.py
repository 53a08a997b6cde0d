"""Training losses: α-balanced focal loss and the rate term.

Port of ``pcc_geo_cnn_v2_tpu/ops/losses.py``: sums, not means, with clip
bounds [1e-3, 0.999], and the bits-per-occupied-voxel normalization
``Σ log p / (−ln2 · Σx)``.

The clip is ``minimum(maximum(p, lo), hi)``, as ``jnp.clip`` is: at a value
equal to a bound both share the gradient (0.5 each), where
``torch.clamp`` passes all of it.

Data-parallel training (``training.Trainer(group=...)``) needs the global
loss of a batch split over ranks, and parts of it are no mean of per-rank
losses: mbpov is a ratio of global sums, and the classification logs are
ratios of global counts. So :func:`rd_loss` takes the global occupied
count as an argument (each rank's loss is then its share of the global
one, and the shares sum to it), and :func:`binary_classification_counts`
gives the counts that the ranks sum before
:func:`binary_classification_from_counts`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["focal_loss", "bits_per_occupied_voxel",
           "binary_classification_counts", "binary_classification_from_counts",
           "binary_classification_metrics", "rd_loss"]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def focal_loss(y_true, y_pred, gamma=2.0, alpha=0.9):
    """Sum-reduced binary focal loss on occupancy probabilities."""
    pt_1 = _clip(torch.where(y_true == 1, y_pred, torch.ones_like(y_pred)),
                 1e-3, 0.999)
    pt_0 = _clip(torch.where(y_true == 0, y_pred, torch.zeros_like(y_pred)),
                 1e-3, 0.999)
    return (-torch.sum(alpha * (1.0 - pt_1) ** gamma * torch.log(pt_1))
            - torch.sum((1 - alpha) * pt_0 ** gamma * torch.log(1.0 - pt_0)))


def bits_per_occupied_voxel(likelihoods, num_occupied):
    """Σ log p / (−ln2 · Σx): mean bits per occupied input voxel."""
    return torch.sum(torch.log(likelihoods)) / (-math.log(2) * num_occupied)


@torch.no_grad()
def binary_classification_counts(x, x_tilde):
    """[tp, tn, fp, fn] of rounded occupancy, one tensor."""
    xq = torch.round(torch.clamp(x, 0, 1))
    xtq = torch.round(torch.clamp(x_tilde, 0, 1))
    return torch.stack([torch.sum(xtq * xq), torch.sum((1 - xtq) * (1 - xq)),
                        torch.sum(xtq * (1 - xq)), torch.sum((1 - xtq) * xq)])


@torch.no_grad()
def binary_classification_metrics(x, x_tilde):
    """Precision / recall / accuracy / specificity / F1 on rounded
    occupancy (reference ``model_types.py:90-105``)."""
    return binary_classification_from_counts(
        binary_classification_counts(x, x_tilde))


def binary_classification_from_counts(counts):
    """The metrics of :func:`binary_classification_metrics` from its
    counts [tp, tn, fp, fn]."""
    tp, tn, fp, fn = counts
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return {
        "bc_precision": precision,
        "bc_recall": recall,
        "bc_accuracy": (tp + tn) / (tp + tn + fp + fn),
        "bc_specificity": tn / (tn + fp),
        "bc_f1": 2 * precision * recall / (precision + recall),
    }


def rd_loss(x, x_tilde, likelihoods_list, lmbda, gamma=2.0, alpha=0.9,
            num_occupied=None):
    """λ·focal + Σ mbpov — the reference's training objective.

    :param likelihoods_list: [y_likelihoods] (v1) or [y, z] (v2).
    :param num_occupied: the mbpov denominator Σx; by default this batch's.
        Given the global batch's count, the loss is this shard's share of
        the global loss (its focal sum and its Σ log p over the global
        denominator), and the shares of all shards sum to it.
    :return: (loss, dict of scalar tensors for logging)
    """
    if num_occupied is None:
        num_occupied = torch.sum(x)
    fl = focal_loss(x, x_tilde, gamma=gamma, alpha=alpha)
    mbpovs = [bits_per_occupied_voxel(p, num_occupied)
              for p in likelihoods_list]
    mbpov = sum(mbpovs)
    loss = lmbda * fl + mbpov
    logs = {"loss": loss, "focal_loss": fl, "mbpov": mbpov,
            "num_occupied_voxels": num_occupied}
    for name, v in zip(("mbpov_y", "mbpov_z"), mbpovs):
        logs[name] = v
    logs.update(binary_classification_metrics(x, x_tilde))
    return loss, logs
