"""Server entry point: `python -m vectordb_tpu_torch [-p PORT] [-r] [-l] [-e URL]
[--device cuda|cpu]` (counterpart of vectordb_tpu/__main__.py).

Mirrors the reference CLI (reference engine cmd/server/main.cpp:33-94):
  -p/--port               HTTP port (default 8888)
  -r/--rebuild true|false background rebuild every RebuildIntervalSeconds
                          (60 s; default true)
  -l/--leader true|false  leader node (default true)
  -e/--embedding_baseurl  embedding sidecar base URL
                          (default http://localhost:8889)
  --device cuda|cpu       the engine's device (default cuda). With cuda and
                          no CUDA device the server exits 2 naming this
                          flag; cpu serves from the CPU with every kernel's
                          plain PyTorch version.

HTTP requests are served from worker threads; the main thread runs the
device executor loop, so device work is serialized like the reference's
executor pool. On a CUDA device every kernel is built before the server
listens, so no request pays for nvcc. SIGINT and SIGTERM stop the executor,
the HTTP server and the rebuild thread, and the process exits 0.

The JAX package also raises WarmupBuckets to 2048 here, so that a client
flood after a rebuild never waits for an XLA compile of a large query
bucket. PyTorch compiles nothing per shape, so the port keeps the library
default (16).
"""
from __future__ import annotations

import argparse
import sys

from ._device import DEVICES


def str2bool(v: str) -> bool:
    return str(v).lower() not in ("false", "0", "no")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="vectordb_tpu_torch")
    parser.add_argument("-p", "--port", type=int, default=8888)
    parser.add_argument("-r", "--rebuild", type=str2bool, default=True,
                        help="enable periodic background rebuild")
    parser.add_argument("-l", "--leader", type=str2bool, default=True,
                        help="run as the leader node")
    parser.add_argument("-e", "--embedding_baseurl", type=str,
                        default="http://localhost:8889")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="the engine's device (cpu only when asked)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import faulthandler
    import signal
    import threading

    # SIGUSR1 dumps all thread stacks to stderr (live-debug aid).
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    import torch

    from ._device import default_device, set_device
    from .db_server import DBServer
    from .logger import logger
    from .rest import create_server
    from .services import EmbeddingService

    if args.device == "cuda" and not torch.cuda.is_available():
        print("vectordb_tpu_torch: --device cuda (the default) but PyTorch "
              "sees no CUDA device; pass --device cpu to serve from the CPU",
              file=sys.stderr)
        return 2
    set_device(args.device)
    dev = default_device()
    if dev.type == "cuda":
        from . import _cuda_build

        _cuda_build.build_all()
        logger.info(f"serving device: {torch.cuda.get_device_name(dev)} "
                    f"({dev}), CUDA kernels built")
    else:
        logger.info("serving device: cpu (--device cpu)")

    db = DBServer()
    db.inject_embedding_service(EmbeddingService(args.embedding_baseurl))
    db.set_leader(args.leader)

    def on_signal(signum, frame):
        db.device_executor.stop()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    httpd = create_server(args.port, db)
    if args.rebuild:
        db.start_rebuild()
    logger.info(f"vectordb-tpu-torch server listening on port "
                f"{httpd.server_address[1]} (leader={args.leader}, "
                f"rebuild={args.rebuild})")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        db.device_executor.run_loop()
    finally:
        db.device_executor.stop()
        httpd.shutdown()
        httpd.server_close()
        db.stop()
        logger.info("server stopped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
