"""Neural-network decoder: an MLP over detector bits, trained on the device.

Counterpart of the reference's `qec/nn_decoder.py` (the original project's
"NN decoders" spec item). Training data comes from the one-matmul fast
sampler, a fresh labeled batch each step, so the loop - sample -> forward
-> loss -> update - runs on the device with no host data pipeline. The
label is the true logical flip (an observable bit); the decoder learns
p(flip | detectors).

With features="pairwise" (the default) the input is the detector bits plus
their pairwise products: matching-class decoders reason over defect PAIRS,
so the pair products make the matching decision surface near-linear. The
pair count is capped at 2^16, keeping the smallest index separations (the
reference's exact numpy call: `np.argsort` is not stable, so its order of
ties is numpy's, not torch's).

The module is an `nn.Module` MLP (hidden sizes (256, 64) by default) with
the reference's He-normal initialization from a torch.Generator seeded by
`seed`; `params_from_numpy` loads the reference's `[(w, b), ...]` weights.
The loss is softplus(where(label, -logit, logit)); training is Adam with
the learning rate on optax's cosine decay to 0 over `steps`, step for step.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn


def cosine_decay(lr: float, steps: int):
    """optax.cosine_decay_schedule(lr, steps) (alpha 0) as a function of the
    update count: lr * (1 + cos(pi * min(count, steps) / steps)) / 2."""
    steps = max(int(steps), 1)
    return lambda count: lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps)
                                                     / steps))


class NNDecoder(nn.Module):
    """Trainable decoder with the standard decode_batch interface.

    fit() (the reference's train()) samples labeled batches from the
    circuit's fast sampler and minimizes the logistic loss of the
    logical-flip bit; decode_batch() thresholds the learned logit at 0.
    train() and eval() are nn.Module's: they set the module's mode only."""

    def __init__(self, circuit, hidden: Sequence[int] = (256, 64),
                 observable: int = 0, seed: int = 0, features: str = "pairwise",
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.circuit = circuit
        self.hidden = tuple(hidden)
        self.observable = observable
        self.seed = seed
        self.features = features
        self.history: List[float] = []
        self.last_decode_seconds = 0.0
        dev = torch.device(device)
        n_det = circuit.n_detectors
        if features == "pairwise":
            iu, ju = np.triu_indices(n_det, k=1)
            if iu.size > 1 << 16:
                keep = np.argsort(np.abs(iu - ju))[: 1 << 16]
                iu, ju = iu[keep], ju[keep]
            self.register_buffer("pair_i", torch.as_tensor(iu, device=dev))
            self.register_buffer("pair_j", torch.as_tensor(ju, device=dev))
            n_in = n_det + int(iu.size)
        elif features == "bits":
            self.register_buffer("pair_i", None)
            self.register_buffer("pair_j", None)
            n_in = n_det
        else:
            raise ValueError("features must be 'bits' or 'pairwise'")
        sizes = [n_in, *self.hidden, 1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.layers = nn.ModuleList()
        for a, b in zip(sizes[:-1], sizes[1:]):
            lin = nn.Linear(a, b, device=dev)
            with torch.no_grad():
                lin.weight.copy_(torch.randn((b, a), generator=gen, device=dev)
                                 * math.sqrt(2.0 / a))
                lin.bias.zero_()
            self.layers.append(lin)

    @property
    def device(self) -> torch.device:
        return self.layers[0].weight.device

    def params_from_numpy(self, params) -> "NNDecoder":
        """Load the reference's parameters, a list of (w (in, out), b (out,))
        numpy arrays, one per layer."""
        if len(params) != len(self.layers):
            raise ValueError(f"{len(params)} layers given, the module has "
                             f"{len(self.layers)}")
        with torch.no_grad():
            for lin, (w, b) in zip(self.layers, params):
                w = torch.as_tensor(np.asarray(w, np.float32)).T
                if w.shape != lin.weight.shape:
                    raise ValueError(f"weight {tuple(w.shape)} for a layer of "
                                     f"{tuple(lin.weight.shape)}")
                lin.weight.copy_(w)
                lin.bias.copy_(torch.as_tensor(np.asarray(b, np.float32)))
        return self

    def featurize(self, dets: torch.Tensor) -> torch.Tensor:
        x = dets.to(torch.float32)
        if self.pair_i is None:
            return x
        return torch.cat([x, x[..., self.pair_i] * x[..., self.pair_j]], dim=-1)

    def forward(self, dets: torch.Tensor) -> torch.Tensor:
        """Detector bits (..., n_det) -> logits (...)."""
        x = self.featurize(dets)
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x)[..., 0]

    def loss(self, dets: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        logits = self(dets)
        return nn.functional.softplus(
            torch.where(labels > 0, -logits, logits)).mean()

    def optimizer(self, steps: int, lr: float = 3e-3):
        """Adam (optax's defaults) and its cosine-decay schedule."""
        opt = torch.optim.Adam(self.parameters(), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        sched_fn = cosine_decay(1.0, steps)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched_fn)

    def train_step(self, opt, sched, dets: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """One Adam update on a labeled batch; returns the loss before it."""
        opt.zero_grad(set_to_none=True)
        loss = self.loss(dets, labels)
        loss.backward()
        opt.step()
        sched.step()
        return loss.detach()

    def fit(self, steps: int = 300, batch: int = 4096, lr: float = 3e-3,
            seed: int = 1) -> "NNDecoder":
        """Training on the device (the reference's NNDecoder.train): a fresh
        sampler batch every step (the sampler is the data loader). The loss
        is recorded every 50 steps and at the last."""
        from .fast_sampler import build_fast_sampler
        sampler = build_fast_sampler(self.circuit, batch, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        opt, sched = self.optimizer(steps, lr)
        for i in range(steps):
            out = sampler(gen)
            loss = self.train_step(opt, sched, out["detectors"],
                                   out["observables"][:, self.observable])
            if i % 50 == 0 or i == steps - 1:
                self.history.append(float(loss))
        return self

    def decode_batch(self, detectors, chunk: int = 8192) -> np.ndarray:
        """Predicted logical flips (S,) int64, in chunks of `chunk` rows so
        the featurized batch (rows x (n_det + n_pairs) float32) never
        materializes whole on the device."""
        t0 = time.perf_counter()
        dets = torch.as_tensor(np.asarray(detectors) if not torch.is_tensor(
            detectors) else detectors)
        with torch.no_grad():
            outs = [(self(dets[i:i + chunk].to(self.device)) > 0).cpu()
                    for i in range(0, dets.shape[0], chunk)]
        self.last_decode_seconds = time.perf_counter() - t0
        return torch.cat(outs).numpy().astype(np.int64)

    def evaluate(self, shots: int = 50000, seed: int = 99) -> Dict:
        """Logical error rate on fresh samples vs the trivial decoder."""
        from .fast_sampler import build_fast_sampler
        sampler = build_fast_sampler(self.circuit, shots, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        out = sampler(gen)
        obs = out["observables"][:, self.observable].cpu().numpy()
        pred = self.decode_batch(out["detectors"])
        return {
            "p_logical_nn": float(np.mean((pred & 1) != (obs & 1))),
            "p_logical_trivial": float(np.mean(obs)),
            "shots": shots,
        }


def train_nn_decoder(d: int = 3, rounds: Optional[int] = None,
                     p: float = 2e-3, steps: int = 300,
                     device: Union[str, torch.device] = "cuda",
                     **kw) -> Tuple[NNDecoder, Dict]:
    """Build the memory circuit, train on `device`, evaluate."""
    from .surface_code import memory_z_circuit
    circuit = memory_z_circuit(d, rounds or d, p=p)
    dec = NNDecoder(circuit, device=device, **kw).fit(steps=steps)
    return dec, dec.evaluate()


__all__ = ["NNDecoder", "train_nn_decoder", "cosine_decay"]
