"""File persistence: camelCase JSON + binary embedding sidecar.

The port of ``typeagent_tpu/knowpro/serialization.py``, with the same file
format (reference ``knowpro/serialization.py:36-250``): ``<name>_data.json``
holds messages/semrefs/indexes with a fileHeader (version 0.1) and an
embeddingFileHeader recording related/message embedding counts;
``<name>_embeddings.bin`` is the raw concatenated float32 matrix, written
byte for byte as the JAX package writes it.

Typed deserialization walks the dataclasses' type hints (``fields.py``)
where the JAX module uses pydantic TypeAdapters; a failure is wrapped as
:class:`DeserializationError` in both.
"""

from __future__ import annotations

import json
from typing import Any, NotRequired, TypedDict

import numpy as np

from . import fields, kplib
from .interfaces import ConversationDataWithIndexes, Tag, Topic

DATA_FILE_SUFFIX = "_data.json"
EMBEDDING_FILE_SUFFIX = "_embeddings.bin"

FILE_VERSION = "0.1"


class FileHeader(TypedDict):
    version: str


class ModelMetadata(TypedDict):
    embeddingSize: int


class EmbeddingFileHeader(TypedDict):
    relatedCount: NotRequired[int | None]
    messageCount: NotRequired[int | None]
    modelMetadata: NotRequired[ModelMetadata | None]


class ConversationJsonData[TMessageData](ConversationDataWithIndexes[TMessageData]):
    fileHeader: NotRequired[FileHeader | None]
    embeddingFileHeader: NotRequired[EmbeddingFileHeader | None]


class ConversationBinaryData(TypedDict):
    embeddingsList: NotRequired[list[np.ndarray] | None]


class ConversationFileData[TMessageData](TypedDict):
    jsonData: ConversationJsonData[TMessageData]
    binaryData: ConversationBinaryData


class DeserializationError(Exception):
    pass


# ---------------------------------------------------------------------------
# Object (de)serialization
# ---------------------------------------------------------------------------


def serialize_object(arg: Any) -> Any:
    """Dataclass -> plain camelCase data, None kept as None (None passes
    through)."""
    if arg is None:
        return None
    if not fields.is_camel_dataclass(arg):
        raise TypeError(f"Object must be a camelCase dataclass, got {type(arg)}")
    return fields.serialize_object(arg, exclude_none=False)


def deserialize_object(typ: Any, obj: Any) -> Any:
    """Validate camelCase data into the given (possibly generic/union) type."""
    try:
        return fields.deserialize_object(typ, obj)
    except Exception as e:
        raise DeserializationError(
            f"Validation failed for {typ!r}: {e}"
        ) from e


TYPE_MAP = {
    "entity": kplib.ConcreteEntity,
    "action": kplib.Action,
    "topic": Topic,
    "tag": Tag,
}


def deserialize_knowledge(knowledge_type: str, obj: Any) -> Any:
    return deserialize_object(TYPE_MAP[knowledge_type], obj)


# ---------------------------------------------------------------------------
# File persistence
# ---------------------------------------------------------------------------


def write_conversation_data_to_file[TMessageData](
    conversation_data: ConversationDataWithIndexes[TMessageData],
    filename: str,
) -> None:
    """Write <filename>_data.json (+ _embeddings.bin when embeddings exist)."""
    file_data = to_conversation_file_data(conversation_data)
    embeddings_list = file_data["binaryData"].get("embeddingsList")
    if embeddings_list:
        with open(filename + EMBEDDING_FILE_SUFFIX, "wb") as f:
            for embeddings in embeddings_list:
                np.asarray(embeddings, dtype=np.float32).tofile(f)
    with open(filename + DATA_FILE_SUFFIX, "w", encoding="utf-8") as f:
        # json.dumps encodes in C; json.dump writes the same text through
        # the pure-Python encoder, about four times slower.
        f.write(json.dumps(file_data["jsonData"]))


def to_conversation_file_data[TMessageData](
    conversation_data: ConversationDataWithIndexes[TMessageData],
) -> ConversationFileData[TMessageData]:
    """Split embeddings out of the JSON tree into the binary sidecar."""
    embedding_file_header = EmbeddingFileHeader()
    embeddings_list: list[np.ndarray] = []
    embedding_size = 0

    related = conversation_data.get("relatedTermsIndexData")
    if related is not None:
        text_embedding_data = related.get("textEmbeddingData")
        if text_embedding_data is not None:
            embeddings = text_embedding_data.get("embeddings")
            if embeddings is not None:
                embeddings_list.append(embeddings)
                text_embedding_data["embeddings"] = None
                embedding_file_header["relatedCount"] = len(embeddings)
                if embedding_size == 0 and embeddings.ndim == 2:
                    embedding_size = embeddings.shape[1]

    message_index_data = conversation_data.get("messageIndexData")
    if message_index_data is not None:
        index_data = message_index_data.get("indexData")
        if index_data is not None:
            embeddings = index_data.get("embeddings")
            if embeddings is not None:
                embeddings_list.append(embeddings)
                index_data["embeddings"] = None
                embedding_file_header["messageCount"] = len(embeddings)
                if embedding_size == 0 and embeddings.ndim == 2:
                    embedding_size = embeddings.shape[1]

    if embedding_size > 0:
        embedding_file_header["modelMetadata"] = ModelMetadata(
            embeddingSize=embedding_size
        )

    json_data = ConversationJsonData(
        **conversation_data,
        fileHeader=FileHeader(version=FILE_VERSION),
        embeddingFileHeader=embedding_file_header,
    )
    return ConversationFileData(
        jsonData=json_data,
        binaryData=ConversationBinaryData(embeddingsList=embeddings_list),
    )


def read_conversation_data_from_file(
    filename: str, embedding_size: int | None = None
) -> ConversationDataWithIndexes[Any]:
    """Read the JSON + sidecar pair back into conversation data."""
    with open(filename + DATA_FILE_SUFFIX, encoding="utf-8") as f:
        json_data: ConversationJsonData[Any] = json.load(f)
    embeddings: np.ndarray | None = None
    header = json_data.get("embeddingFileHeader")
    if header is None:
        raise DeserializationError("Missing embedding file header")
    if embedding_size is None:
        model_meta = header.get("modelMetadata")
        embedding_size = model_meta["embeddingSize"] if model_meta else 0
    if embedding_size:
        try:
            flat = np.fromfile(
                filename + EMBEDDING_FILE_SUFFIX, dtype=np.float32
            )
            embeddings = flat.reshape(-1, embedding_size)
        except FileNotFoundError:
            embeddings = None
    binary = ConversationBinaryData(
        embeddingsList=[embeddings] if embeddings is not None else []
    )
    return from_conversation_file_data(
        ConversationFileData(jsonData=json_data, binaryData=binary)
    )


def from_conversation_file_data(
    file_data: ConversationFileData[Any],
) -> ConversationDataWithIndexes[Any]:
    json_data = file_data["jsonData"]
    file_header = json_data.get("fileHeader")
    if file_header is None:
        raise DeserializationError("Missing file header")
    if file_header["version"] != FILE_VERSION:
        raise DeserializationError(
            f"Unsupported file version {file_header['version']}"
        )
    embedding_file_header = json_data.get("embeddingFileHeader")
    if embedding_file_header is None:
        raise DeserializationError("Missing embedding file header")

    binary_data = file_data["binaryData"]
    if binary_data:
        embeddings_list = binary_data.get("embeddingsList")
        if embeddings_list:
            if len(embeddings_list) != 1:
                raise ValueError(
                    f"Expected embeddings list of length 1, got {len(embeddings_list)}"
                )
            embeddings = embeddings_list[0]
            pos = 0
            pos += _slice_embeddings_into(
                embeddings,
                json_data,
                ("relatedTermsIndexData", "textEmbeddingData"),
                pos,
                embedding_file_header.get("relatedCount"),
            )
            pos += _slice_embeddings_into(
                embeddings,
                json_data,
                ("messageIndexData", "indexData"),
                pos,
                embedding_file_header.get("messageCount"),
            )
    return json_data


def _slice_embeddings_into(
    embeddings: np.ndarray,
    json_data: ConversationJsonData[Any],
    keys: tuple[str, ...],
    offset: int,
    count: int | None,
) -> int:
    if count is None or count <= 0:
        return 0
    window = embeddings[offset : offset + count]
    if len(window) != count:
        raise DeserializationError(f"Expected {count} embeddings, got {len(window)}")
    data: Any = json_data
    for key in keys:
        data = data.get(key) if isinstance(data, dict) else None
        if data is None or not isinstance(data, dict):
            return 0
    if "embeddings" in data:
        data["embeddings"] = window
    return count
