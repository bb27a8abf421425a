"""The MM-GAN container (reference ``MultiModalGAN``,
`MMGAN_MIDI_DES/network_tests.py:163-206`) and the experimental ``SimNN``
(port of ``gandes_tpu/models/composite.py``).

``MultiModalGAN`` holds ``generator1``, ``generator2`` and
``discriminator`` under the reference's attribute names, so that a
reference ``mmgan_*_epoch_*.pth`` (or the JAX package's ``export-torch
--model mmgan`` output) loads with ``load_state_dict``. It is also the
reference's object-style surface: ``forward`` is G1+G2 -> host DES round
trip -> DiscriminatorCNN, returning (logits, failed_sim_count). The round
trip is ``matrix_to_midi`` with the arguments given to the constructor
(``instrument``, ``start``, ``end``, ``log_path``, ``out_dir``), or a
``decode`` callable the caller passes (the training loop's own,
``train/mmgan_loop.py::make_decode``). The generator outputs are detached
before it, as the reference detaches them, so it is non-differentiable
through the simulator. ``train()`` / ``eval()`` (``nn.Module``'s) choose
train-mode G (BatchNorm statistics updated) or eval-mode G;
``generate_midi`` writes ``generation.mid``. Training runs the steps in
``train/steps.py``.

Default widths: z 50, 64x64 adjacency, G2 output 20 — the reference
training's (``MMGANConfig``), which the reference checkpoints carry. The
JAX class defaults to the reference constructor's z 100, 28x28, output 16;
an intended divergence (``ROADMAP.md``), pass those to get its shapes.
So is ``forward``'s fourth positional argument: ``decode`` here, where the
JAX class takes ``count`` (``forward(noise1, noise2, input_tensor,
count=0)``), so that the port's callers that pass ``decode`` positionally
keep working. A JAX-style ``model(n1, n2, beats, 3)`` raises a
``TypeError`` that says to pass ``count=`` by keyword.

``SimNN`` (`GAN_DES/SIMNN.py:145-198`), the reference's experimental
five-head CNN, which its training never calls: (B, 1, H, W) -> two [3x3
conv (32, 64 channels, padding 1) -> ReLU -> 2x2 max-pool] stages -> Dense
512 -> ReLU -> Dense n^2 + 4n, split into the (B, n, n) matrix and four
(B, n) heads. flax flattens the NHWC map in (h, w, c) order and torch the
NCHW map in (c, h, w) order: ``fc1``'s input rows are in torch's order, and
``train/convert.py::simnn_state_dict_from_flax`` permutes a JAX kernel's
rows into it. Init: flax's default (``lecun_normal_``) from a
``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gandes_tpu_torch.models.initializers import lecun_normal_
from gandes_tpu_torch.models.mmgan import BeatGenerator, DiscriminatorCNN, MLPGenerator


class MultiModalGAN(nn.Module):
    def __init__(self, z_dim: int = 50, hidden_dim: int = 64, adj_size=(64, 64),
                 roll_size=(2, 128, 50), input_dim: int = 50, output_dim: int = 20,
                 instrument=None, start: int = 30, end: int = 80, seed: int = 0,
                 log_path: str = "logs/", out_dir: str = "./adj_sim_outputs/midi",
                 generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.z_dim = z_dim
        self.adj_size = tuple(adj_size)
        self.instrument, self.start, self.end = instrument, start, end
        self.log_path, self.out_dir = log_path, out_dir
        self.generator1 = MLPGenerator(z_dim=z_dim, hidden_dim=hidden_dim, input_dim=z_dim,
                                       adj_size=adj_size, generator=generator,
                                       compute_dtype=compute_dtype)
        self.generator2 = BeatGenerator(z_dim=z_dim, hidden_dim=hidden_dim,
                                        input_dim=input_dim, output_dim=output_dim,
                                        generator=generator, compute_dtype=compute_dtype)
        self.discriminator = DiscriminatorCNN(roll_size=roll_size, generator=generator,
                                              compute_dtype=compute_dtype)

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    def _decode(self, mats, vec, count, generate=False):
        """``matrix_to_midi`` with the constructor's arguments: (rolls, failed)."""
        from gandes_tpu_torch.bridge.mmgan_decode import matrix_to_midi

        return matrix_to_midi(
            mats.float().cpu().numpy()[:, None], vec.float().cpu().numpy(),
            adj_size=self.adj_size, instrument=self.instrument, start=self.start, end=self.end,
            count=count, generate=generate, log_path=self.log_path, out_dir=self.out_dir)

    def forward(self, noise1, noise2, beats, decode=None, count: int = 0,
                aux: torch.Tensor | None = None):
        """G (train mode updates the BatchNorm statistics) -> the DES round
        trip -> D logits; returns (logits, failed). ``decode(mats, vec,
        count) -> (fake, failed)`` where given, else ``matrix_to_midi`` with
        the constructor's arguments. Numpy or tensor inputs go to the
        model's device.

        Without ``aux``, G1's aux input is drawn from a ``torch.Generator``
        seeded with ``count`` (the JAX composite draws it from
        ``jax.random.key(count)``: another stream)."""
        if decode is not None and not callable(decode):
            raise TypeError(f"MultiModalGAN.forward: decode must be callable or None, got "
                            f"{type(decode).__name__}; the fourth positional argument is "
                            f"decode here (the JAX class's is count): pass count= by keyword")
        device = self._device()
        noise1, noise2, beats = (torch.as_tensor(x).to(device, torch.float32)
                                 for x in (noise1, noise2, beats))
        if aux is None:
            aux = torch.randn(noise1.shape[0], self.z_dim,
                              generator=torch.Generator().manual_seed(count))
        with torch.no_grad():
            mats = self.generator1(noise1, torch.as_tensor(aux).to(device, torch.float32))
            vec = self.generator2(noise2, beats)
        if decode is not None:
            fake, failed = decode(mats, vec, count)
        else:
            rolls, failed = self._decode(mats, vec, count)
            fake = torch.from_numpy(np.stack(rolls)).to(device, torch.float32)
        return self.discriminator(fake), failed

    def generate_midi(self, noise1, noise2, beats, aux=None):
        """Inference (network_tests.py:198-206): eval mode, eval-mode G1/G2
        (G1's aux ``aux``, else ``AUX_INPUT`` for every row, as every
        ported inference path draws it) -> ``matrix_to_midi(generate=True)``,
        which writes ``generation.mid`` into ``out_dir``; returns the rolls."""
        from gandes_tpu_torch.train.mmgan_loop import eval_forward

        self.eval()
        mats, vec = eval_forward(self, noise1, noise2, beats, aux)
        rolls, _ = self._decode(mats, vec, 0, generate=True)
        return rolls


class SimNN(nn.Module):
    """Experimental multi-head CNN (`GAN_DES/SIMNN.py:145-198`) on (B, 1, H,
    W) inputs of ``input_hw``; see the module docstring."""

    def __init__(self, n: int, input_hw=(64, 64), generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n = n
        h, w = input_hw[0] // 4, input_hw[1] // 4
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = nn.Linear(64 * h * w, 512)
        self.fc2 = nn.Linear(512, n * n + 4 * n)
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
            lecun_normal_(layer, generator)

    def forward(self, x):
        x = nn.functional.max_pool2d(torch.relu(self.conv1(x)), 2)
        x = nn.functional.max_pool2d(torch.relu(self.conv2(x)), 2)
        out = self.fc2(torch.relu(self.fc1(x.flatten(1))))
        n = self.n
        return (out[:, :n * n].reshape(-1, n, n),
                *(out[:, n * n + k * n:n * n + (k + 1) * n] for k in range(4)))

    @staticmethod
    def create_model(n: int, input_hw=(64, 64)) -> "SimNN":
        """== reference ``SimNN.create_model`` (GAN_DES/SIMNN.py:171-173)."""
        return SimNN(n, input_hw)

    def pretrain_model(self, pretrain_data, num_epochs: int = 5, lr: float = 1e-3) -> list:
        """The runnable version of reference ``SimNN.pretrain_model``
        (GAN_DES/SIMNN.py:175-191), as the JAX package defines it: regress the
        five heads onto ``(spectrograms, targets)`` batches of
        ``pretrain_data`` by the sum of their MSEs, with Adam at ``lr``
        (optax's betas and eps), ``num_epochs`` passes, in place. Returns the
        losses, one per batch."""
        device = self._device()
        opt = torch.optim.Adam(self.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        losses = []
        self.train()
        for _ in range(num_epochs):
            for spectrograms, targets in pretrain_data:
                outs = self(torch.as_tensor(spectrograms).to(device, torch.float32))
                loss = sum(torch.mean((o - torch.as_tensor(t).to(device, torch.float32)) ** 2)
                           for o, t in zip(outs, targets, strict=True))
                opt.zero_grad()
                loss.backward()
                opt.step()
                losses.append(loss.item())
        return losses

    def _device(self) -> torch.device:
        return next(self.parameters()).device

    @staticmethod
    def error_system(output):
        """== reference ``SimNN.error_system`` (GAN_DES/SIMNN.py:193-198): a
        placeholder that returns None, as in the JAX package (the reference
        body can only crash, and nothing calls it)."""
        return None
