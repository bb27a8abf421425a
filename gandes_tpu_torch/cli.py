"""Command line of the PyTorch/CUDA port: ``python -m gandes_tpu_torch.cli``.

Only ``serve`` is ported, with ``gandes_tpu/cli.py``'s flags:

    python -m gandes_tpu_torch.cli serve --model gandes [--torch-checkpoint gen.pt]

``--checkpoint`` (an orbax directory) needs JAX to read: convert it with
``python -m gandes_tpu.cli export-torch --model gandes --checkpoint DIR
--out gen.pt`` and pass ``--torch-checkpoint gen.pt``. ``--start`` and
``--sequence-length`` configure the MM-GAN family, which is not ported yet;
they are accepted so that command lines written for ``gandes_tpu`` parse.
"""

from __future__ import annotations

import argparse


def _cmd_serve(args):
    from gandes_tpu_torch.serve import run_server

    if args.checkpoint:
        raise SystemExit(
            "--checkpoint takes an orbax directory, which needs JAX to read; convert it "
            "with `python -m gandes_tpu.cli export-torch --model gandes --checkpoint "
            f"{args.checkpoint} --out gen.pt` and pass --torch-checkpoint gen.pt")
    run_server(model=args.model, torch_checkpoint=args.torch_checkpoint, host=args.host,
               port=args.port, warmup=not args.no_warmup, sound_font=args.sound_font,
               device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="gandes_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="warm-model HTTP generation server")
    sp.add_argument("--model", choices=["mmgan", "gandes", "both"], default="gandes",
                    help="only 'gandes' is ported; 'mmgan' and 'both' raise")
    sp.add_argument("--checkpoint", default=None,
                    help="orbax checkpoint dir: rejected, see export-torch")
    sp.add_argument("--torch-checkpoint", default=None,
                    help="a reference .pt state_dict (or export-torch output)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8472)
    sp.add_argument("--no-warmup", action="store_true")
    sp.add_argument("--start", type=int, default=100, help="MM-GAN only (not ported)")
    sp.add_argument("--sequence-length", type=int, default=50,
                    help="MM-GAN only (not ported)")
    sp.add_argument("--sound-font", default=None,
                    help=".sf2 path: SF2 playback is not ported and raises")
    sp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    sp.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
