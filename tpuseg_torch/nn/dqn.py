"""DQN instance selector (port of ``tpuseg/nn/dqn.py``): the dueling-DQN
conv Q-net ``RLSelect``, a ``ReplayBuffer`` and ``DQNSelecter`` with its
target network, double-DQN TD loss and target sync every 100 frames.

Kept from the JAX package: ``q_values`` always runs the Q-net's BatchNorms
in eval mode, so their statistics never update; the optimizer is Adam at
1e-3 (``torch.optim.Adam``, optax's ``adam(1e-3)``).  The replay buffer
samples from its own seeded ``random.Random``, the epsilon-greedy draws
come from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import collections
import copy
import math
import random
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from tpuseg_torch import resolve_device
from tpuseg_torch.nn.blocks import _BN, relu6

_NEG = -1e30


class RLSelect(nn.Module):
    """Conv Q-network over (B, C, H, W) features -> (B, H*W) Q-values:
    3 depthwise-separable blocks (C -> 8 -> 12 -> 6), the mask re-applied
    before each, then a 1x1 head."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        for i, oup in enumerate((8, 12, 6)):
            self.add_module(f"Conv_{2 * i}", nn.Conv2d(
                c, c, 3, padding=1, groups=c, bias=False))
            self.add_module(f"_BN_{2 * i}", _BN(c))
            self.add_module(f"Conv_{2 * i + 1}",
                            nn.Conv2d(c, oup, 1, bias=False))
            self.add_module(f"_BN_{2 * i + 1}", _BN(oup))
            c = oup
        self.Conv_6 = nn.Conv2d(c, 1, 1)

    def forward(self, feature, mask):
        b, _, h, w = feature.shape
        m = mask.reshape(b, 1, h, w).to(feature.dtype)
        for i in range(3):
            feature = feature * m
            for j in (2 * i, 2 * i + 1):
                conv, bn = getattr(self, f"Conv_{j}"), getattr(self, f"_BN_{j}")
                feature = relu6(bn(conv(feature)))
        return self.Conv_6(feature).reshape(b, h * w)


class ReplayBuffer:
    def __init__(self, capacity: int, seed: int = 0):
        self.buffer = collections.deque(maxlen=capacity)
        self.rng = random.Random(seed)

    def push(self, transitions):
        """transitions: per-field sequences (state, action, reward, mask,
        next_mask, done), zipped into one entry per sample."""
        self.buffer += list(zip(*transitions))

    def sample(self, batch_size: int):
        batch = self.rng.sample(list(self.buffer), batch_size)
        return tuple(map(np.stack, zip(*batch)))

    def __len__(self):
        return len(self.buffer)


class DQNSelecter:
    """Double-DQN trainer around ``RLSelect`` (``net``) and its target copy
    (``target_net``), both in eval mode for every Q-value."""

    def __init__(self, net: RLSelect, gamma: float = 0.99,
                 epsilon_start: float = 1.0, epsilon_end: float = 0.01,
                 epsilon_decay: float = 500.0, buffer_capacity: int = 60,
                 buffer_start: int = 20, dqn_batch_size: int = 4,
                 seed: int = 0):
        self.net = net.eval()
        self.target_net = copy.deepcopy(net).eval()
        for p in self.target_net.parameters():
            p.requires_grad_(False)
        self.opt = torch.optim.Adam(self.net.parameters(), lr=1e-3)
        self.gamma = gamma
        self.epsilon_start = epsilon_start
        self.epsilon_end = epsilon_end
        self.epsilon_decay = epsilon_decay
        self.frame = 0
        self.buffer_start = buffer_start
        self.dqn_batch_size = dqn_batch_size
        self.buffer = ReplayBuffer(buffer_capacity, seed)

    @classmethod
    def create(cls, channels: int, seed: int = 0, device="cuda", **kw
               ) -> "DQNSelecter":
        """A selecter whose Q-net is initialised from ``seed``."""
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = RLSelect(channels)
        return cls(net.to(dev), seed=seed, **kw)

    def load_flax(self, params, target_params, batch_stats) -> None:
        """The JAX selecter's trees (numpy leaves): ``params`` into
        ``net``, ``target_params`` into ``target_net``, the shared
        ``batch_stats`` into both."""
        from tpuseg_torch.weights import load_flax

        load_flax(self.net, {"params": params, "batch_stats": batch_stats})
        load_flax(self.target_net, {"params": target_params,
                                    "batch_stats": batch_stats})

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    @property
    def epsilon(self) -> float:
        return self.epsilon_end + (self.epsilon_start - self.epsilon_end) * (
            math.exp(-1.0 * self.frame / self.epsilon_decay))

    def q_values(self, state, mask, net: Optional[RLSelect] = None):
        """state (B, C, H, W), mask (B, H*W) -> (B, H*W)."""
        return (net or self.net)(state, mask)

    def act(self, generator: Optional[torch.Generator], state, mask):
        """Epsilon-greedy action among the pixels where ``mask`` > 0: (B,)
        flat pixel indices.  Exploration picks a uniform masked pixel (any
        pixel where the mask is empty)."""
        self.frame += 1
        with torch.no_grad():
            q = self.q_values(state, mask)
        allowed = mask > 0
        greedy = torch.where(allowed, q, torch.full_like(q, _NEG)).argmax(1)
        weights = allowed.to(torch.float32)
        weights[weights.sum(1) == 0] = 1.0
        rand_act = torch.multinomial(weights, 1, generator=generator)[:, 0]
        u = torch.rand((q.shape[0],), generator=generator, device=q.device)
        return torch.where(u < self.epsilon, rand_act, greedy)

    def td_loss(self, batch: Sequence[torch.Tensor]) -> torch.Tensor:
        """Double-DQN TD loss of ``net`` on (state, action, reward, mask,
        next_mask, done)."""
        state, action, reward, mask, next_mask, done = batch
        q_values = self.q_values(state, mask)
        q_value = q_values.gather(1, action.long()[:, None])[:, 0]
        next_q = self.q_values(state, next_mask)
        next_q_target = self.q_values(state, next_mask, self.target_net)
        next_best = torch.where(next_mask > 0, next_q,
                                torch.full_like(next_q, _NEG)).argmax(1)
        next_q_value = next_q_target.gather(1, next_best[:, None])[:, 0]
        expected = reward + self.gamma * next_q_value * (1.0 - done.float())
        return ((q_value - expected.detach()) ** 2).mean()

    def update(self) -> None:
        """One Adam step on a sampled batch once the buffer holds
        ``buffer_start`` transitions; the target net takes the Q-net's
        weights every 100 frames."""
        if len(self.buffer) >= self.buffer_start:
            dev = self.device
            batch = [torch.as_tensor(a, device=dev)
                     for a in self.buffer.sample(self.dqn_batch_size)]
            self.opt.zero_grad(set_to_none=True)
            self.td_loss(batch).backward()
            self.opt.step()
        if self.frame % 100 == 0:
            self.target_net.load_state_dict(self.net.state_dict())
