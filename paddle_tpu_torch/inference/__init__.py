"""paddle_tpu_torch.inference — the serving plane: the continuous-batching
engine, the router over a pool of engines, and the multi-process fleet
(what ``paddle_tpu/inference/__init__.py`` exposes of these).

``python -m paddle_tpu_torch.inference.engine_server --config c.json
--port-file p`` serves one engine to other processes.
"""
from .serving import ContinuousBatchingEngine, GenerationRequest
from .router import (ServingRouter, EngineHandle, RouterRequest,
                     RouterQueueFull)
from .fleet import (RemoteEngineClient, EngineServer, EngineProcess,
                    EngineRPCError, RetryPolicy)

__all__ = ["ContinuousBatchingEngine", "GenerationRequest",
           "ServingRouter", "EngineHandle", "RouterRequest",
           "RouterQueueFull", "RemoteEngineClient", "EngineServer",
           "EngineProcess", "EngineRPCError", "RetryPolicy"]
