"""K1, the piano-roll rasterizer kernel, and its plain PyTorch version.

``rasterize_cuda`` launches the hand-written CUDA kernel
(``csrc/roll_rasterize.cu``; it replaces ``gandes_tpu/ops/pallas_roll.py``'s
Pallas kernel) on CUDA tensors and raises on anything else: the kernel is
never emulated. ``rasterize_events_reference`` is the plain version, a port
of ``gandes_tpu/music/piano_roll.py::_rasterize_math``: two last-writer
passes with ``scatter_reduce(reduce="amax")`` over flat ``note * T + t`` cell
ids plus a dump slot. The CPU tests run it, and the kernel is held against
it on the card. ``music/piano_roll.py::rasterize_events`` picks one by the
tensors' device.

Both take int32 (B, E) event arrays (``note = -1`` pads a slot; ``on``/``off``
are steps before the crop by ``start``) and return (B, 2, 128, T) float32:
channel 0 the velocity at onset, channel 1 ``off - on`` painted over
``[on, off)``, later events overwriting earlier ones. The values are small
integers in float32, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "roll_rasterize.cu")


def _last_writer(ids, order, values, mask, n_cells):
    """(B, n_cells): ``values`` scattered at ``ids``, the highest ``order``
    winning each cell; masked entries go to the dump slot ``n_cells``."""
    B = ids.shape[0]
    ids = torch.where(mask, ids, n_cells).reshape(B, -1)
    order = torch.where(mask, order, -1).reshape(B, -1)
    best = torch.full((B, n_cells + 1), -1, dtype=order.dtype, device=ids.device)
    best = best.scatter_reduce(1, ids, order, reduce="amax")
    win = mask.reshape(B, -1) & (order == torch.gather(best, 1, ids))
    vals = torch.where(win, values.reshape(B, -1), 0.0)
    out = torch.zeros((B, n_cells + 1), dtype=torch.float32, device=ids.device)
    out = out.scatter_reduce(1, ids, vals, reduce="amax")
    return out[:, :n_cells]


def rasterize_events_reference(notes, ons, offs, vels, *, num_steps: int, start: int = 0):
    """Plain PyTorch rasterizer (``_rasterize_math``'s two segment-max passes).

    Memory is O(B * E * T) for the duration channel; the kernel's is not."""
    T = int(num_steps)
    notes = notes.to(torch.int64)
    ons = ons.to(torch.int64) - start
    offs = offs.to(torch.int64) - start
    vels = vels.to(torch.int64)
    B, E = notes.shape
    n_cells = 128 * T
    valid = (notes >= 0) & (notes < 128)
    order = torch.arange(E, device=notes.device).expand(B, E)

    # channel 0: roll[note, on] = velocity (vel < 0 marks duration-only
    # events from orphan note_offs)
    on_mask = valid & (ons >= 0) & (ons < T) & (vels >= 0)
    vel_roll = _last_writer(notes * T + ons, order, vels.to(torch.float32), on_mask, n_cells)

    # channel 1: durations[note, on:off] = off - on, painted per step
    steps = torch.arange(T, device=notes.device)
    span = (steps >= ons[..., None]) & (steps < offs[..., None]) & valid[..., None]
    dur = (offs - ons).to(torch.float32)
    dur_roll = _last_writer(notes[..., None] * T + steps, order[..., None].expand(B, E, T),
                            dur[..., None].expand(B, E, T), span, n_cells)
    return torch.stack([vel_roll, dur_roll], 1).reshape(B, 2, 128, T)


class _Kernel:
    """The built library, made once."""

    def __init__(self):
        from gandes_tpu_torch.ops.build import build_cuda_lib

        self.lib, self.build_log = build_cuda_lib(_SRC, "libroll_rasterize")
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.roll_rasterize_launch.argtypes = [p, p, p, p, i, i, i, i, p, p]
        self.lib.roll_rasterize_launch.restype = i
        self.lib.roll_rasterize_error_string.argtypes = [i]
        self.lib.roll_rasterize_error_string.restype = ctypes.c_char_p
        self.launch = self.lib.roll_rasterize_launch


_KERNEL: _Kernel | None = None
_KERNEL_LOCK = threading.Lock()


def kernel() -> _Kernel:
    """The built kernel; the first call compiles ``csrc/roll_rasterize.cu``."""
    global _KERNEL
    if _KERNEL is None:
        with _KERNEL_LOCK:
            if _KERNEL is None:
                _KERNEL = _Kernel()
    return _KERNEL


_INT32_MAX = 2**31 - 1


def rasterize_cuda(notes, ons, offs, vels, *, num_steps: int, start: int = 0):
    """(B, 2, 128, T) rolls from the CUDA kernel, any T >= 1; the event
    arrays must be contiguous int32 (B, E) CUDA tensors on one device.
    Counts each launch in ``rasterize_cuda.launches``."""
    arrays = (notes, ons, offs, vels)
    if not all(isinstance(a, torch.Tensor) and a.is_cuda for a in arrays):
        raise ValueError("rasterize_cuda takes CUDA tensors; CPU tensors take "
                         "rasterize_events_reference")
    shape, device = notes.shape, notes.device
    for a in arrays:
        if (a.dtype != torch.int32 or a.dim() != 2 or a.shape != shape
                or a.device != device or not a.is_contiguous()):
            raise ValueError(f"rasterize_cuda takes four contiguous int32 (B, E) tensors on "
                             f"one device, got {a.dtype} {tuple(a.shape)} on {a.device} "
                             f"contiguous={a.is_contiguous()}")
    B, E = shape
    T = int(num_steps)
    if T < 1:
        raise ValueError(f"num_steps={T}: the roll needs at least one step")
    if B > _INT32_MAX or E > _INT32_MAX or T > _INT32_MAX or abs(int(start)) > _INT32_MAX:
        raise ValueError(f"B={B}, E={E}, T={T} and start={start} must fit in int32")
    launch = kernel().launch
    out = torch.empty((B, 2, 128, T), dtype=torch.float32, device=device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (notes.data_ptr(), ons.data_ptr(), offs.data_ptr(), vels.data_ptr(), B, E, T,
            int(start), out.data_ptr(), stream)
    if device.index == torch.cuda.current_device():
        err = launch(*args)
    else:  # the launch goes to the calling thread's current device
        with torch.cuda.device(device):
            err = launch(*args)
    if err != 0:
        raise RuntimeError("roll_rasterize kernel launch failed: "
                           + kernel().lib.roll_rasterize_error_string(err).decode())
    rasterize_cuda.launches += 1
    return out


rasterize_cuda.launches = 0
