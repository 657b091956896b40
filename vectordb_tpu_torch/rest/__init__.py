from .server import RestServer, create_server

__all__ = ["RestServer", "create_server"]
