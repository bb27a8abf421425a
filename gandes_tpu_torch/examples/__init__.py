"""The example harnesses of the port (counterparts of ``examples/``), each run
with ``python -m gandes_tpu_torch.examples.<name>`` and each exposing the
``run(..., device=...)`` that its ``main()`` calls:

- ``ingest_bench``         — MAESTRO-volume pickling in the sequential,
                             ``workers`` and ``device_rasterize`` modes
                             (kernel K1 in the last two).
- ``train_surrogate_demo`` — MM-GAN training through the DES and the
                             real-vs-generated roll gap before and after.
- ``train_gandes_demo``    — GAN-DES training through the DES and the mel
                             gap before and after (kernel K2 per real slice
                             and per clip).
- ``ref_schedule_run``     — MM-GAN at the reference's scale (5,392
                             windows, 337 steps an epoch, 40 epochs),
                             resumable.
"""
