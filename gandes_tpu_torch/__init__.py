"""gandes_tpu_torch — the PyTorch/CUDA port of ``gandes_tpu``.

The JAX package ``gandes_tpu`` stays the reference; this package mirrors its
layout so each module's counterpart is found under the same path:

- ``core``   — RNG stream discipline, the event-log codec and the phase
               timer (host copies).
- ``des``    — the discrete-event simulator; the C++ core is built from the
               repository's ``native/des_engine.cpp`` into ``_build/``.
- ``music``  — MIDI codec, log->MIDI generators, piano rolls (host loop and
               the batched rasterizer), beats, the additive synth and mel
               spectrograms (torch).
- ``data``   — WAV I/O, the MM-GAN datasets and the MAESTRO pickler.
- ``models`` — ``torch.nn`` modules (the GAN-DES DCGAN generator and mel
               discriminator, the MM-GAN generators and discriminators,
               the learned DES surrogates).
- ``ops``    — hand-written CUDA kernels, each beside its plain PyTorch
               version; sources under ``ops/csrc/``, built at first use.
- ``bridge`` — matrix -> DES -> MIDI -> WAV -> mel (``matrix_to_wav``) and
               matrices -> DES -> MIDI -> roll (``matrix_to_midi``).
- ``train``  — configs, weight loading and conversion from the JAX package,
               the train steps, loops and checkpoints of both families.
- ``eval``   — music-quality statistics of rolls and mels
               (``eval-metrics``).
- ``serve``  — the HTTP generation server; ``cli`` its command line.
- ``bench``  — the benchmark (``cli bench``); ``demo`` — the end-to-end
               demo script (``python -m gandes_tpu_torch.demo``).
- ``examples`` — the example harnesses (ingestion at MAESTRO volume, the
               two training-outcome demos, the reference-schedule run), each
               ``python -m gandes_tpu_torch.examples.<name>``.

Entry points take a ``device`` argument that defaults to ``"cuda"``; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.

This package imports neither ``jax`` nor ``gandes_tpu``. Weights trained in
the JAX package cross through ``python -m gandes_tpu.cli export-torch``
(a reference-layout ``state_dict``) and ``--torch-checkpoint``.
"""

import torch

__version__ = "0.1.0"


def use_f32_numerics() -> None:
    """Full float32 contractions on the card, as the JAX package runs them.

    cuDNN would otherwise run the DCGAN's transposed convolutions in TF32,
    and TF32's 10-bit mantissa corrupts the low-power bins of a DFT. The
    bfloat16 products of ``compute_dtype='bf16'`` accumulate in float32
    too, as XLA's do: PyTorch would otherwise let cuBLAS reduce their
    split-K partial sums in bfloat16."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


use_f32_numerics()
