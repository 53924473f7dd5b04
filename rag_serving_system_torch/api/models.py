"""API request schema: a copy of `rag_serving_system_tpu/api/models.py`."""

from pydantic import BaseModel, Field


class QueryRequest(BaseModel):
    query: str = Field(max_length=100_000)
    # clamped server-side to the engine's max_k
    k: int = Field(default=2, ge=1, le=1024)
    # optional per-request generation budget, clamped server-side to
    # MAX_NEW_TOKENS; None = that cap
    max_new_tokens: int | None = Field(default=None, ge=1, le=1024)
