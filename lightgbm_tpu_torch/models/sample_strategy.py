"""Row sampling strategies: bagging and GOSS.

Counterpart of the JAX package's ``models/sample_strategy.py``
(src/boosting/sample_strategy.{h,cpp}, bagging.hpp, goss.hpp).

Bagging draws its bag on the host once per `bagging_freq` iterations from
``np.random.RandomState(bagging_seed + iteration)``, in the same draw order
as the JAX package, so both packages train on the same rows.

GOSS keeps the rows of largest |g·h| and a sample of the rest. Its
selection (`goss_select`) runs where the gradients are: on the card for a
CUDA tensor, on the CPU for a CPU one, with the same PyTorch ops. The only
host work an iteration is the MT19937 position draw, which consumes the
generator as the JAX package's host path does (`choice(n_rest, k)` and
`choice(rest, k)` both reduce to `permutation(n_rest)[:k]`). The bag stays
on the gradients' device as a `DeviceBag`; a learner that needs host
indices pulls them once a bag (`host_bag_indices`). The JAX host path is
kept as `GOSSStrategy.bagging_host`, the oracle the selection is held to.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.log import Log
from ..utils.timer import global_timer


class SampleStrategy:
    """Base: no sampling (full data every iteration)."""

    def __init__(self, config: Config, num_data: int, metadata,
                 num_tree_per_iteration: int) -> None:
        self.config = config
        self.num_data = num_data
        self.metadata = metadata
        self.num_tree_per_iteration = num_tree_per_iteration

    def bagging(self, iteration: int, grad, hess
                ) -> Tuple[Optional[np.ndarray], object, object]:
        """Returns (the bag, or None for full data, grad, hess): host
        indices or a DeviceBag, and the gradients, which GOSS rescales."""
        return None, grad, hess


class BaggingSampleStrategy(SampleStrategy):
    """bagging_fraction / bagging_freq (+ pos/neg fractions for binary)
    — bagging.hpp:30-296. The bag is resampled every `bagging_freq`
    iterations and reused in between."""

    def __init__(self, config: Config, num_data: int, metadata,
                 num_tree_per_iteration: int) -> None:
        super().__init__(config, num_data, metadata, num_tree_per_iteration)
        self.balanced = (config.pos_bagging_fraction < 1.0
                         or config.neg_bagging_fraction < 1.0)
        self.need = config.bagging_freq > 0 and (
            config.bagging_fraction < 1.0 or self.balanced)
        if self.balanced and config.objective not in ("binary",):
            Log.warning("Only can use pos/neg bagging with binary objective")
            self.balanced = False
            self.need = config.bagging_freq > 0 and config.bagging_fraction < 1.0
        self._bag: Optional[np.ndarray] = None

    def bagging(self, iteration: int, grad, hess):
        if not self.need:
            return None, grad, hess
        freq = self.config.bagging_freq
        if self._bag is None or iteration % freq == 0:
            rng = np.random.RandomState(self.config.bagging_seed + iteration)
            if self.balanced:
                label = np.asarray(self.metadata.label)
                pos = label > 0
                keep = np.where(
                    pos, rng.rand(self.num_data) < self.config.pos_bagging_fraction,
                    rng.rand(self.num_data) < self.config.neg_bagging_fraction)
                self._bag = np.nonzero(keep)[0].astype(np.int32)
            else:
                cnt = int(round(self.config.bagging_fraction * self.num_data))
                cnt = max(min(cnt, self.num_data), 1)
                self._bag = np.sort(rng.choice(
                    self.num_data, cnt, replace=False)).astype(np.int32)
        return self._bag, grad, hess


class DeviceBag:
    """A bag that lives on the gradients' device: membership as a bool
    mask, the count known on the host from the sizes alone. A learner that
    needs host indices (the serial learner's RowPartition) reads them
    through `.indices`, one pull a bag."""

    def __init__(self, mask: torch.Tensor, n_bag: int, num_data: int) -> None:
        self.mask = mask  # bool [num_data]
        self.n_bag = int(n_bag)
        self.num_data = int(num_data)
        self._host: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.n_bag

    @property
    def indices(self) -> np.ndarray:
        if self._host is None:
            self._host = np.nonzero(self.mask.cpu().numpy())[0].astype(np.int32)
        return self._host


def host_bag_indices(bag):
    """A bag as host int32 indices (host bags as they are)."""
    if isinstance(bag, DeviceBag):
        return bag.indices
    return bag


def goss_score(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """[C, N] float32 -> [N] float32 sum_c |g_c * h_c|, the classes' terms
    added in class order (the JAX package's fixed association, on both of
    its paths)."""
    score = torch.abs(grad[0] * hess[0])
    for c in range(1, grad.shape[0]):
        score = score + torch.abs(grad[c] * hess[c])
    return score


def goss_order(score: torch.Tensor) -> torch.Tensor:
    """The stable ascending order of -score, as int64 row indices: the
    JAX package's `argsort(-score, stable=True)` and numpy's stable
    argsort. The sort runs on an int32 key built from the bits, so no
    device's float sort decides the order: +0.0 and -0.0 share a key (they
    compare equal), every NaN sorts last (numpy's order; JAX standardizes
    NaN to the largest value), and a larger |g·h| comes first."""
    bits = score.view(torch.int32) & 0x7FFFFFFF  # |score|: -0.0 -> 0
    key = torch.where(torch.isnan(score), torch.full_like(bits, 0x7F800001),
                      0x7F800000 - bits)
    return torch.sort(key, stable=True).indices


def goss_select(grad: torch.Tensor, hess: torch.Tensor, sampled_pos: torch.Tensor,
                multiplier: float, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GOSS's selection (the JAX package's `_goss_select`) on the gradients'
    device: the top `top_k` rows of the order, and the rows at positions
    `sampled_pos` (int64, drawn on the host) of the rest of it, the latter's
    g and h multiplied by the float32 `multiplier`. grad, hess [C, N]
    float32. Returns (the in-bag mask [N] bool, grad, hess); nothing
    reaches the host."""
    N = grad.shape[1]
    order = goss_order(goss_score(grad, hess))
    mask = torch.zeros(N, dtype=torch.bool, device=grad.device)
    mask[order[:top_k]] = True
    if sampled_pos.shape[0] > 0:
        sampled = order[top_k:][sampled_pos]
        mask[sampled] = True
        scaled = torch.zeros(N, dtype=torch.bool, device=grad.device)
        scaled[sampled] = True
        mult = torch.tensor(multiplier, dtype=torch.float32, device=grad.device)
        grad = torch.where(scaled[None, :], grad * mult, grad)
        hess = torch.where(scaled[None, :], hess * mult, hess)
    return mask, grad, hess


class GOSSStrategy(SampleStrategy):
    """Gradient-based One-Side Sampling — goss.hpp:30-172.

    Keeps the top `top_rate` fraction of rows by sum_c |g_c·h_c|, samples
    `other_rate` of the rest, and scales the sampled rows' grad/hess by
    (1 - top_rate) / other_rate. No sampling during the warm-up, while
    iteration < int(1 / learning_rate), as the reference."""

    def __init__(self, config: Config, num_data: int, metadata,
                 num_tree_per_iteration: int) -> None:
        super().__init__(config, num_data, metadata, num_tree_per_iteration)
        if config.top_rate + config.other_rate > 1.0:
            Log.fatal("The sum of top_rate and other_rate cannot be greater than 1.0")
        if config.top_rate <= 0.0 or config.other_rate <= 0.0:
            # goss.hpp CHECK: both subsample fractions must be positive
            Log.fatal("top_rate and other_rate must be positive in GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            Log.warning("Cannot use bagging in GOSS")

    def sizes(self) -> Tuple[int, int, int]:
        """(top_k, n_rest, n_sampled)."""
        n = self.num_data
        top_k = max(int(math.ceil(n * self.config.top_rate)), 1)
        other_k = int(math.ceil(n * self.config.other_rate))
        n_rest = n - top_k
        n_sampled = min(other_k, n_rest) if (other_k > 0 and n_rest > 0) else 0
        return top_k, n_rest, n_sampled

    def multiplier(self) -> float:
        return (1.0 - self.config.top_rate) / max(self.config.other_rate, 1e-12)

    def sampling(self, iteration: int) -> bool:
        lr = max(self.config.learning_rate, 1e-12)
        return iteration >= int(1.0 / lr)

    def draw_positions(self, iteration: int) -> np.ndarray:
        """The iteration's sample positions into the rest of the order, from
        the host's MT19937."""
        _, n_rest, n_sampled = self.sizes()
        rng = np.random.RandomState(self.config.bagging_seed + iteration)
        if n_sampled > 0:
            return rng.choice(n_rest, n_sampled, replace=False)
        return np.empty(0, dtype=np.int64)

    def bagging(self, iteration: int, grad, hess):
        if not self.sampling(iteration):
            return None, grad, hess
        top_k, _, n_sampled = self.sizes()
        with global_timer.scope("goss_draw"):
            pos = torch.from_numpy(self.draw_positions(iteration).astype(np.int64)).to(
                grad.device)
        with global_timer.scope("goss_select"):
            mask, grad, hess = goss_select(grad, hess, pos, self.multiplier(), top_k)
        return DeviceBag(mask, top_k + n_sampled, self.num_data), grad, hess

    def bagging_host(self, iteration: int, grad: torch.Tensor, hess: torch.Tensor):
        """The JAX package's host path (sample_strategy.py:228-262): the
        score and the stable argsort in numpy, the sample drawn from the
        rows of the rest, a host index bag. The oracle `bagging` is held
        to; training does not call it."""
        if not self.sampling(iteration):
            return None, grad, hess
        g = grad.cpu().numpy().astype(np.float32)
        h = hess.cpu().numpy().astype(np.float32)
        score = np.abs(g[0] * h[0])
        for c in range(1, g.shape[0]):
            score = score + np.abs(g[c] * h[c])
        top_k, _, n_sampled = self.sizes()
        order = np.argsort(-score, kind="stable")
        top, rest = order[:top_k], order[top_k:]
        rng = np.random.RandomState(self.config.bagging_seed + iteration)
        if n_sampled > 0:
            sampled = rng.choice(rest, n_sampled, replace=False)
        else:
            sampled = np.empty(0, dtype=np.int64)
        if len(sampled) > 0:
            idx = torch.from_numpy(np.sort(sampled).astype(np.int64)).to(grad.device)
            mult = torch.tensor(self.multiplier(), dtype=torch.float32, device=grad.device)
            grad, hess = grad.clone(), hess.clone()
            grad[:, idx] = grad[:, idx] * mult
            hess[:, idx] = hess[:, idx] * mult
        bag = np.sort(np.concatenate([top, sampled])).astype(np.int32)
        return bag, grad, hess


def create_sample_strategy(config: Config, num_data: int, metadata,
                           num_tree_per_iteration: int) -> SampleStrategy:
    """sample_strategy.cpp:27: data_sample_strategy in {bagging, goss}; the
    legacy boosting=goss spelling is normalized by the config layer."""
    strategy = config.data_sample_strategy
    if strategy == "goss" or config.boosting == "goss":
        return GOSSStrategy(config, num_data, metadata, num_tree_per_iteration)
    if strategy == "bagging":
        return BaggingSampleStrategy(config, num_data, metadata,
                                     num_tree_per_iteration)
    Log.fatal("Unknown data sample strategy: %s", strategy)
