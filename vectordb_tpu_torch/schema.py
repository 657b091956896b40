"""Schema types: field types, metric types, table/database schemas.

Semantics mirror the reference's meta types
(reference db/catalog/meta_types.hpp:19-112), including the
numeric enum values used in the on-disk catalog JSON, so catalogs written by
the reference engine load here unchanged.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

import numpy as np

from .errors import Status, USER_ERROR

DEFAULT_MODEL_NAME = "BAAI/bge-small-en-v1.5"


class FieldType(enum.IntEnum):
    INT1 = 1   # TINYINT
    INT2 = 2   # SMALLINT
    INT4 = 3   # INT
    INT8 = 4   # BIGINT
    FLOAT = 10
    DOUBLE = 11
    STRING = 20
    BOOL = 30
    JSON = 31
    VECTOR_FLOAT = 40
    VECTOR_DOUBLE = 41
    SPARSE_VECTOR_FLOAT = 50
    SPARSE_VECTOR_DOUBLE = 51
    GEO_POINT = 60
    UNKNOWN = 999


class MetricType(enum.IntEnum):
    EUCLIDEAN = 1
    COSINE = 2
    DOT_PRODUCT = 3
    UNKNOWN = 999


FIELD_TYPE_NAMES = {
    "TINYINT": FieldType.INT1,
    "SMALLINT": FieldType.INT2,
    "INT": FieldType.INT4,
    "BIGINT": FieldType.INT8,
    "FLOAT": FieldType.FLOAT,
    "DOUBLE": FieldType.DOUBLE,
    "STRING": FieldType.STRING,
    "BOOL": FieldType.BOOL,
    "JSON": FieldType.JSON,
    "VECTOR_FLOAT": FieldType.VECTOR_FLOAT,
    "VECTOR_DOUBLE": FieldType.VECTOR_DOUBLE,
    "SPARSE_VECTOR_FLOAT": FieldType.SPARSE_VECTOR_FLOAT,
    "SPARSE_VECTOR_DOUBLE": FieldType.SPARSE_VECTOR_DOUBLE,
    "GEO_POINT": FieldType.GEO_POINT,
    "UNKNOWN": FieldType.UNKNOWN,
}

METRIC_TYPE_NAMES = {
    "EUCLIDEAN": MetricType.EUCLIDEAN,
    "COSINE": MetricType.COSINE,
    "DOT_PRODUCT": MetricType.DOT_PRODUCT,
}

DENSE_VECTOR_TYPES = (FieldType.VECTOR_FLOAT, FieldType.VECTOR_DOUBLE)
SPARSE_VECTOR_TYPES = (FieldType.SPARSE_VECTOR_FLOAT, FieldType.SPARSE_VECTOR_DOUBLE)
VECTOR_TYPES = DENSE_VECTOR_TYPES + SPARSE_VECTOR_TYPES
# The sparse CSR holds term ids as int32 (ops/sparse.SparseColumnIndex).
MAX_SPARSE_DIMENSIONS = 2**31 - 1
INT_TYPES = (FieldType.INT1, FieldType.INT2, FieldType.INT4, FieldType.INT8)

# numpy dtype for each primitive attribute column.
PRIMITIVE_DTYPES = {
    FieldType.INT1: np.int8,
    FieldType.INT2: np.int16,
    FieldType.INT4: np.int32,
    FieldType.INT8: np.int64,
    FieldType.FLOAT: np.float32,
    FieldType.DOUBLE: np.float64,
    FieldType.BOOL: np.bool_,
}


def get_field_type(name: str) -> FieldType:
    return FIELD_TYPE_NAMES.get(name.upper(), FieldType.UNKNOWN)


def get_metric_type(name: str) -> MetricType:
    return METRIC_TYPE_NAMES.get(name.upper(), MetricType.UNKNOWN)


@dataclass
class FieldSchema:
    id: int = 0
    name: str = ""
    is_primary_key: bool = False
    is_index_field: bool = False
    field_type: FieldType = FieldType.INT4
    vector_dimension: int = 0
    metric_type: MetricType = MetricType.EUCLIDEAN

    def is_dense_vector(self) -> bool:
        return self.field_type in DENSE_VECTOR_TYPES

    def is_sparse_vector(self) -> bool:
        return self.field_type in SPARSE_VECTOR_TYPES

    def is_vector(self) -> bool:
        return self.field_type in VECTOR_TYPES

    # Catalog JSON — field names and numeric enums match the reference
    # (basic_meta_impl.cpp:38-127) so catalog files interoperate.
    def to_json(self) -> Dict[str, Any]:
        out = {
            "id": self.id,
            "name": self.name,
            "isPrimaryKey": self.is_primary_key,
            "isIndexField": self.is_index_field,
            "fieldType": int(self.field_type),
        }
        if self.is_vector():
            out["vectorDimension"] = self.vector_dimension
            out["metricType"] = int(self.metric_type)
        return out

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "FieldSchema":
        f = FieldSchema(
            id=int(j.get("id", 0)),
            name=j.get("name", ""),
            is_primary_key=bool(j.get("isPrimaryKey", False)),
            is_index_field=bool(j.get("isIndexField", False)),
            field_type=FieldType(int(j.get("fieldType", int(FieldType.INT4)))),
        )
        if f.is_vector():
            f.vector_dimension = int(j.get("vectorDimension", 0))
            f.metric_type = MetricType(int(j.get("metricType", int(MetricType.EUCLIDEAN))))
        return f


@dataclass
class AutoEmbedding:
    src_field_id: int = 0
    tgt_field_id: int = 0
    model_name: str = DEFAULT_MODEL_NAME

    def to_json(self) -> Dict[str, Any]:
        return {
            "srcFieldId": self.src_field_id,
            "tgtFieldId": self.tgt_field_id,
            "modelName": self.model_name,
        }

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "AutoEmbedding":
        return AutoEmbedding(
            src_field_id=int(j.get("srcFieldId", 0)),
            tgt_field_id=int(j.get("tgtFieldId", 0)),
            model_name=j.get("modelName", DEFAULT_MODEL_NAME),
        )


@dataclass
class Index:
    """A content index: source text field -> hidden embedding vector field
    (reference meta_types.hpp:68-75)."""

    name: str = ""
    field_name: str = ""
    embedding_model_name: str = ""
    src_field_id: int = 0
    tgt_field_id: int = 0
    dimensions: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "model": self.embedding_model_name,
            "srcFieldId": self.src_field_id,
            "tgtFieldId": self.tgt_field_id,
            "dimensions": self.dimensions,
        }

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "Index":
        return Index(
            name=j.get("name", ""),
            embedding_model_name=j.get("model", ""),
            src_field_id=int(j.get("srcFieldId", 0)),
            tgt_field_id=int(j.get("tgtFieldId", 0)),
            dimensions=int(j.get("dimensions", 0)),
        )


@dataclass
class TableSchema:
    id: int = 0
    name: str = ""
    fields: List[FieldSchema] = dc_field(default_factory=list)
    indices: List[Index] = dc_field(default_factory=list)
    auto_embeddings: List[AutoEmbedding] = dc_field(default_factory=list)

    def field_map(self) -> Dict[str, FieldSchema]:
        return {f.name: f for f in self.fields}

    def field_type_map(self) -> Dict[str, FieldType]:
        return {f.name: f.field_type for f in self.fields}

    def primary_key_field(self) -> Optional[FieldSchema]:
        for f in self.fields:
            if f.is_primary_key:
                return f
        return None

    def vector_fields(self) -> List[FieldSchema]:
        return [f for f in self.fields if f.is_vector()]

    def dense_vector_fields(self) -> List[FieldSchema]:
        return [f for f in self.fields if f.is_dense_vector()]

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "id": self.id,
            "name": self.name,
            "fields": [f.to_json() for f in self.fields],
        }
        if self.auto_embeddings:
            out["autoEmbeddings"] = [e.to_json() for e in self.auto_embeddings]
        if self.indices:
            out["indices"] = [i.to_json() for i in self.indices]
        return out

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "TableSchema":
        return TableSchema(
            id=int(j.get("id", 0)),
            name=j.get("name", ""),
            fields=[FieldSchema.from_json(x) for x in j.get("fields", [])],
            indices=[Index.from_json(x) for x in j.get("indices", [])],
            auto_embeddings=[AutoEmbedding.from_json(x)
                             for x in j.get("autoEmbeddings", [])],
        )


@dataclass
class DatabaseSchema:
    id: int = 0
    name: str = ""
    path: str = ""
    tables: List[TableSchema] = dc_field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"id": self.id, "tables": [t.to_json() for t in self.tables]}

    @staticmethod
    def from_json(j: Dict[str, Any], name: str = "", path: str = "") -> "DatabaseSchema":
        return DatabaseSchema(
            id=int(j.get("id", 0)),
            name=name,
            path=path,
            tables=[TableSchema.from_json(t) for t in j.get("tables", [])],
        )


def parse_table_schema_from_user_json(body: Dict[str, Any]) -> TableSchema:
    """Parse a user-facing create-table payload (reference
    db_server.cpp:140-217): fields carry `name`, `dataType`, `primaryKey`,
    `dimensions`, `metricType`; optional `autoEmbedding` list.

    Raises VectorDBError(USER_ERROR, ...) on invalid payloads.
    """
    from .errors import VectorDBError

    if "name" not in body:
        raise VectorDBError(USER_ERROR, "Missing table name in your payload.")
    schema = TableSchema(name=body["name"])
    if "fields" not in body:
        raise VectorDBError(USER_ERROR, "Missing fields in your payload.")
    has_pk = False
    for i, bf in enumerate(body["fields"]):
        f = FieldSchema(id=i, name=bf.get("name", ""))
        if bf.get("primaryKey"):
            if has_pk:
                raise VectorDBError(USER_ERROR, "At most one field can be primary key.")
            f.is_primary_key = True
            has_pk = True
        if "dataType" in bf:
            f.field_type = get_field_type(str(bf["dataType"]))
        if f.field_type in VECTOR_TYPES and "dimensions" not in bf:
            raise VectorDBError(USER_ERROR, "Vector field must have dimensions.")
        if "dimensions" in bf:
            f.vector_dimension = int(bf["dimensions"])
        if f.is_sparse_vector() and f.vector_dimension > MAX_SPARSE_DIMENSIONS:
            # Divergence: the JAX package accepts such a field, and its
            # int32 CSR indices wrap silently.
            raise VectorDBError(
                USER_ERROR, f"Sparse vector field {f.name} has "
                f"{f.vector_dimension} dimensions; at most "
                f"{MAX_SPARSE_DIMENSIONS} are supported (term ids are int32 "
                "on the device).")
        if "metricType" in bf:
            f.metric_type = get_metric_type(str(bf["metricType"]))
            if f.metric_type == MetricType.UNKNOWN:
                raise VectorDBError(USER_ERROR,
                                    "invalid metric type: " + str(bf["metricType"]))
        schema.fields.append(f)
    for be in body.get("autoEmbedding", []):
        schema.auto_embeddings.append(AutoEmbedding(
            src_field_id=int(be["source"]),
            tgt_field_id=int(be["target"]),
            model_name=be.get("modelName", DEFAULT_MODEL_NAME),
        ))
    # Optional content indices: {"name", "field", "model", "dimensions"}
    for bi in body.get("indices", []):
        schema.indices.append(Index(
            name=bi.get("name", ""),
            field_name=bi.get("field", ""),
            embedding_model_name=bi.get("model", DEFAULT_MODEL_NAME),
            dimensions=int(bi.get("dimensions", 0)),
        ))
    return schema
