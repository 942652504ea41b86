from .engine import Request, ServingEngine
from .server import CompletionServer

__all__ = ["Request", "ServingEngine", "CompletionServer"]
