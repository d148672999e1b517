from .semantic_map import SemanticMapper, MapperParams

__all__ = ["SemanticMapper", "MapperParams"]
