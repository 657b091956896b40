"""Embedding-service HTTP client (counterpart of
vectordb_tpu/services/embedding.py, host code copied).

Mirrors the reference's EmbeddingService (reference engine services/
embedding_service.{hpp,cpp}): a client for the embedding sidecar at
`http://localhost:8889` speaking `GET/POST /v1/embeddings` (plus VoyageAI
contextualized `/v1/contextualizedembeddings` and multimodal
`/v1/multimodalembeddings` routes), with per-provider API-key forwarding,
3x/2x retries and exponential backoff with jitter
(embedding_service.hpp:24-28). Uses urllib (stdlib) — this is a control-plane
HTTP client, not a perf path.
"""
from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..errors import (INFRA_UNEXPECTED_ERROR, INVALID_PAYLOAD, VectorDBError)
from ..logger import logger

EMBEDDING_DOCS_RETRY = 3
EMBEDDING_QUERY_RETRY = 2
BACKOFF_INITIAL_DELAY_S = 1
BACKOFF_EXP_BASE = 2
BACKOFF_JITTER = 1

OPENAI_KEY_HEADER = "X-OpenAI-API-Key"
JINAAI_KEY_HEADER = "X-JinaAI-API-Key"
VOYAGEAI_KEY_HEADER = "X-VoyageAI-API-Key"
MIXEDBREADAI_KEY_HEADER = "X-MixedbreadAI-API-Key"
NOMIC_KEY_HEADER = "X-NOMIC-API-Key"
MISTRALAI_KEY_HEADER = "X-MistralAI-API-Key"

_PROVIDER_HEADERS = {
    "openai/": (OPENAI_KEY_HEADER, "Missing OpenAI API key."),
    "jinaai/": (JINAAI_KEY_HEADER, "Missing JinaAI API key."),
    "voyageai/": (VOYAGEAI_KEY_HEADER, "Missing VoyageAI API key."),
    "mixedbreadai/": (MIXEDBREADAI_KEY_HEADER, "Missing mixedbread ai API key."),
    "nomicai/": (NOMIC_KEY_HEADER, "Missing Nomic API key."),
    "mistralai/": (MISTRALAI_KEY_HEADER, "Missing MistralAI API key."),
}


@dataclass
class EmbeddingModel:
    model: str
    dim: int
    dense: bool = True
    dimension_reduction: bool = False


class EmbeddingService:
    def __init__(self, base_url: str, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self._models_cache: Optional[List[EmbeddingModel]] = None

    # ---- HTTP plumbing ------------------------------------------------

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None,
                 headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        data = json.dumps(body).encode("utf-8") if body is not None else None
        req = urllib.request.Request(self.base_url + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            if v:
                req.add_header(k, v)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def _retry(self, fn, attempts: int, what: str):
        for attempt in range(attempts):
            try:
                result = fn()
                if result is not None:
                    return result
            except VectorDBError:
                raise
            except Exception as e:
                logger.error(f"Exception in {what}: {e}")
            if attempt + 1 >= attempts:
                break
            delay = BACKOFF_INITIAL_DELAY_S * (BACKOFF_EXP_BASE
                                               ** (attempt + 1))
            if BACKOFF_JITTER:
                delay += random.random()
            time.sleep(delay)
            logger.info(f"Retry {what}.")
        raise VectorDBError(INFRA_UNEXPECTED_ERROR,
                            f"Failed to {what}.")

    def _provider_headers(self, model_name: str,
                          headers: Dict[str, str]) -> Dict[str, str]:
        for prefix, (header, err) in _PROVIDER_HEADERS.items():
            if model_name.startswith(prefix):
                if header not in headers:
                    raise VectorDBError(INVALID_PAYLOAD, err)
                return {header: headers[header]}
        return {}

    # ---- API ----------------------------------------------------------

    def get_supported_models(self) -> List[EmbeddingModel]:
        if self._models_cache is not None:
            return self._models_cache
        try:
            j = self._request("GET", "/v1/embeddings")
            models = [EmbeddingModel(
                model=m.get("model", ""), dim=int(m.get("dim", 0)),
                dense=bool(m.get("dense", True)),
                dimension_reduction=bool(m.get("dimensionReduction", False)))
                for m in j.get("result", [])]
            self._models_cache = models
            return models
        except Exception as e:
            logger.error(f"Exception in getSupportedModels: {e}")
            raise VectorDBError(INFRA_UNEXPECTED_ERROR,
                                "Failed to load supported embedding models.")

    def dense_embed_documents(self, model_name: str, documents: List[str],
                              dimension: int, headers: Dict[str, str],
                              reduce_dimension: bool = False
                              ) -> List[List[float]]:
        is_context = "voyage-context" in model_name
        is_multimodal = "voyage-multimodal" in model_name
        if is_context or is_multimodal:
            if VOYAGEAI_KEY_HEADER not in headers:
                raise VectorDBError(INVALID_PAYLOAD, "Missing VoyageAI API key.")
            key = {VOYAGEAI_KEY_HEADER: headers[VOYAGEAI_KEY_HEADER]}
            if is_context:
                body = {"model": model_name, "input_type": "document",
                        "output_dtype": "float",
                        "inputs": [[d] for d in documents]}
                if reduce_dimension and dimension > 0:
                    body["output_dimension"] = dimension
                path = "/v1/contextualizedembeddings"
            else:
                body = {"model": model_name, "input_type": "document",
                        "truncation": True,
                        "inputs": [[d] for d in documents]}
                path = "/v1/multimodalembeddings"

            def call():
                j = self._request("POST", path, body, key)
                if j.get("statusCode") == 200:
                    return j["result"]
                logger.error("VoyageAI embedding response: " + json.dumps(j))
                return None

            return self._retry(call, EMBEDDING_DOCS_RETRY,
                               "embed the documents with VoyageAI")

        key = self._provider_headers(model_name, headers)
        body = {"model": model_name, "documents": documents,
                "dimensions": dimension if reduce_dimension else 0}

        def call():
            j = self._request("POST", "/v1/embeddings", body, key)
            if j.get("statusCode") == 200:
                return j["result"]
            logger.error("Embedding response: " + json.dumps(j))
            return None

        return self._retry(call, EMBEDDING_DOCS_RETRY, "embbed the documents")

    def dense_embed_query(self, model_name: str, query: str, dimension: int,
                          headers: Dict[str, str],
                          reduce_dimension: bool = False) -> List[float]:
        is_context = "voyage-context" in model_name
        is_multimodal = "voyage-multimodal" in model_name
        if is_context or is_multimodal:
            if VOYAGEAI_KEY_HEADER not in headers:
                raise VectorDBError(INVALID_PAYLOAD, "Missing VoyageAI API key.")
            key = {VOYAGEAI_KEY_HEADER: headers[VOYAGEAI_KEY_HEADER]}
            if is_context:
                body = {"model": model_name, "input_type": "query",
                        "output_dtype": "float", "inputs": [[query]]}
                if reduce_dimension and dimension > 0:
                    body["output_dimension"] = dimension
                path = "/v1/contextualizedembeddings"
            else:
                body = {"model": model_name, "input_type": "query",
                        "truncation": True, "inputs": [[query]]}
                path = "/v1/multimodalembeddings"

            def call():
                j = self._request("POST", path, body, key)
                if j.get("statusCode") == 200:
                    return j["result"][0]
                logger.error("VoyageAI embedding response: " + json.dumps(j))
                return None

            return self._retry(call, EMBEDDING_QUERY_RETRY,
                               "embed the query with VoyageAI")

        key = self._provider_headers(model_name, headers)
        body = {"model": model_name, "documents": [query],
                "dimensions": dimension if reduce_dimension else 0}

        def call():
            j = self._request("POST", "/v1/embeddings", body, key)
            if j.get("statusCode") == 200:
                return j["result"][0]
            logger.error("Embedding response: " + json.dumps(j))
            return None

        return self._retry(call, EMBEDDING_QUERY_RETRY, "embed the query")
