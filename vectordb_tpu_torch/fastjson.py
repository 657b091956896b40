"""Loader for the native JSON encoder (native/vdb_fastjson.so).

The REST response encoder is the single-core serving hot path: stdlib
json.dumps spends its time on shortest-repr float formatting (the
reference serializes responses in compiled C++, oatpp DTOs in
web_controller.hpp); rest/server.py encodes its responses with it
(dumps_bytes, and table.ColumnarRows.encode_json for query rows). The C
encoder formats float32-origin values with %.9g (exact binary32
round-trip, ~15x faster) and falls back to json.dumps per call on any unsupported type,
or entirely when the extension is missing. Disable with
VECTORDB_TPU_NATIVE=off.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Any

from ._native_build import ensure_built
from .logger import logger

_native_dumps = None
_native_dumps_rows = None
if os.environ.get("VECTORDB_TPU_NATIVE", "").lower() != "off":
    try:
        # Content-hash-keyed build (never a committed binary, never an
        # mtime race after a fresh clone) — see _native_build.ensure_built.
        _so = ensure_built("vdb_fastjson.so", ["vdbjson.c"])
        spec = (importlib.util.spec_from_file_location("vdb_fastjson", _so)
                if _so else None)
        if spec and spec.loader:
            _mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(_mod)
            _native_dumps = _mod.dumps
            _native_dumps_rows = getattr(_mod, "dumps_rows", None)
            logger.debug("native JSON encoder loaded")
    except Exception as e:  # toolchain-optional: stdlib fallback
        logger.debug(f"native JSON encoder unavailable: {e}")
        _native_dumps = None


def dumps_bytes(obj: Any) -> bytes:
    """JSON-encode to UTF-8 bytes (json.dumps ensure_ascii semantics)."""
    if _native_dumps is not None:
        try:
            return _native_dumps(obj)
        except (TypeError, ValueError):
            # TypeError: non-JSON-native type (e.g. numpy scalar).
            # ValueError: the C encoder's depth cap (200) is tighter than
            # json.dumps' (~1000); deep-but-valid payloads must still
            # serialize through the fallback, not fail the request.
            pass
    return json.dumps(obj).encode("utf-8")


def dumps_rows_bytes(names, kinds: str, cols, distances) -> bytes | None:
    """JSON bytes for a result-row array, written directly from column
    buffers by the C encoder (the reference serializes from compiled C++
    DTOs, web_controller.hpp). Returns None when the native encoder is
    unavailable or refuses the columns — callers fall back to the
    dict-rows path."""
    if _native_dumps_rows is None:
        return None
    try:
        return _native_dumps_rows(names, kinds, cols, distances)
    except (TypeError, ValueError):
        return None
