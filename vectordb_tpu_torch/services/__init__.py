from .embedding import EmbeddingModel, EmbeddingService

__all__ = ["EmbeddingModel", "EmbeddingService"]
