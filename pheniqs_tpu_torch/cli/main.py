"""`python -m pheniqs_tpu_torch mux ...` — the port's command line.

The same interface as ``pheniqs_tpu.cli.main`` (the port's copy of
``cli/interface.py``); ``--fidelity fast|hybrid`` run on the port's device
engines, on the device named by ``PHENIQS_TORCH_DEVICE`` (default
``cuda``), ``strict`` on its copy of the strict engines. With
``PHENIQS_TP=R:P`` it is one of R * P ranks under ``torchrun``
(``device/distributed.py``). Installed, it is the console script
``pheniqs-tpu-torch``.
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    from ..job import run_job

    argv = list(sys.argv if argv is None else argv)
    if argv and argv[0].endswith(("main.py", "__main__.py")):
        # @PG/CL lines carry the program name, as the reference CLI's do
        argv[0] = "pheniqs-tpu"
    return run_job(argv)


def entrypoint() -> int:
    """console_scripts shim: argv[0] becomes the installed binary name."""
    return main(sys.argv)


if __name__ == "__main__":
    sys.exit(main())
