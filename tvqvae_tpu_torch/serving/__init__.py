from .server import make_server, serve_forever
from .service import GenerationService, postprocess_generated

__all__ = ["GenerationService", "make_server", "serve_forever", "postprocess_generated"]
