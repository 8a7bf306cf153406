"""Deterministic synthetic data (port of ``repro.data.pipeline``). The LM
stream's batches are a pure function of (seed, step, host id), made with
numpy exactly as the reference makes them; the teacher-student batches are
drawn on the device from the reference's ``jax.random`` keys
(``core.prng``). Both are handed over as tensors on the chosen device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve


class SyntheticLMDataset:
    """Markov-ish token stream with a learnable bigram structure: next token
    = ``(a · tok + b) % vocab``, replaced by a uniform token with
    probability ``noise``."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 n_hosts: int = 1, host_id: int = 0, noise: float = 0.05, device=None):
        self.vocab, self.seq_len, self.global_batch = vocab, seq_len, global_batch
        self.seed, self.noise = seed, noise
        self.n_hosts, self.host_id = n_hosts, host_id
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split over {n_hosts} hosts")
        self.local_batch = global_batch // n_hosts
        self.device = resolve(device)
        rng = np.random.default_rng(seed)
        self.a = int(rng.integers(2, max(3, vocab - 1)))
        self.b = int(rng.integers(1, vocab))

    def batch_numpy(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step, self.host_id))
        x = np.empty((self.local_batch, self.seq_len + 1), np.int64)
        x[:, 0] = rng.integers(0, self.vocab, self.local_batch)
        noise = rng.random((self.local_batch, self.seq_len)) < self.noise
        rnd = rng.integers(0, self.vocab, (self.local_batch, self.seq_len))
        for t in range(self.seq_len):
            nxt = (self.a * x[:, t] + self.b) % self.vocab
            x[:, t + 1] = np.where(noise[:, t], rnd[:, t], nxt)
        return {"inputs": x[:, :-1], "labels": x[:, 1:]}

    def batch(self, step: int) -> dict:
        """``{"inputs", "labels"}``: int64 [local_batch, seq_len] tensors on
        the dataset's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.batch_numpy(step).items()}


class FrameStub:
    """The stand-in frontend of an ``input_mode="embeddings"`` model
    (musicgen-large's EnCodec frames): a fixed N(0, 1) table ``[vocab, d]``
    from ``seed``, so a token stream becomes frame embeddings ``[..., d]``
    and a decoded codebook token the next step's frame. The reference's
    launchers have no frontend; the port's use this one."""

    def __init__(self, vocab: int, d_model: int, seed: int = 0, device=None):
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.table = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=dev)

    def __call__(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens]


def fan_in_normal(key: tuple, shape: tuple, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape) / np.sqrt(shape[0])`` in f32: the
    reference's teacher and MLP initializers. The divisor is a tensor on
    the same device, so the card divides as the CPU does (a host scalar
    divisor becomes a reciprocal multiply there)."""
    w = prng.normal(key, shape, device=device)
    return w / torch.tensor(float(np.float32(np.sqrt(shape[0]))), dtype=torch.float32, device=w.device)


class TeacherStudentDataset:
    """A fixed random-teacher regression batch (the Fig 9/10-style
    experiments): ``y = relu(x @ w1) @ w2`` with a ``[d_in, 4·d_in]`` and a
    ``[4·d_in, d_out]`` teacher and ``batch`` inputs, drawn under ``split(
    PRNGKey(seed), 3)`` as the reference draws them."""

    def __init__(self, d_in: int, d_out: int, batch: int, seed: int = 0, device=None):
        dev = resolve(device)
        k1, k2, k3 = prng.split(prng.PRNGKey(seed), 3)
        self.w1 = fan_in_normal(k1, (d_in, 4 * d_in), device=dev)
        self.w2 = fan_in_normal(k2, (4 * d_in, d_out), device=dev)
        self.x = prng.normal(k3, (batch, d_in), device=dev)
        self.y = torch.relu(self.x @ self.w1) @ self.w2

    def batch(self, step: int = 0) -> tuple:
        return self.x, self.y
