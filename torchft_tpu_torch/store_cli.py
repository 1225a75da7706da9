"""Standalone Store server CLI.

The port of ``torchft_tpu/store_cli.py``: a rendezvous endpoint (wire
methods 20-23, docs/wire.md) that a replica group's host-rank-0 process
can serve, for any coordination key; locally it is a long-lived store for
manual multi-process drives::

    python -m torchft_tpu_torch.store_cli --bind "[::]:29500"
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.store_cli",
        description="Serve a standalone tpu-ft Store (framed-TCP protobuf, "
        "docs/wire.md) until interrupted.",
    )
    parser.add_argument("--bind", default="[::]:29500", help="host:port to bind")
    args = parser.parse_args(argv)

    from torchft_tpu_torch.coordination import StoreServer

    store = StoreServer(bind=args.bind)
    print(f"[tpuft_store] listening on {store.address()}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 130
    finally:
        store.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
