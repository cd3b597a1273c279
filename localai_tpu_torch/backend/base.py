"""Base servicer + descriptor-driven gRPC registration (counterpart of
localai_tpu/backend/base.py): handlers are derived from the proto
DESCRIPTOR at run time, no generated service stubs. Every RPC a role does
not override answers UNIMPLEMENTED."""
from __future__ import annotations

import grpc

from localai_tpu_torch.backend import pb


def _unimplemented(name):
    def handler(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED,
                      f"{name} not implemented by this backend")

    handler.__name__ = name
    return handler


class BackendServicer:
    """Override the RPCs your backend supports; the rest stay UNIMPLEMENTED."""

    def Health(self, request, context):
        return pb.Reply(message=b"OK")


for _m in pb.SERVICE.methods:
    if not hasattr(BackendServicer, _m.name):
        setattr(BackendServicer, _m.name, _unimplemented(_m.name))


def add_backend_servicer(server: grpc.Server, servicer: BackendServicer):
    """Register `servicer` under the Backend service using generic handlers."""
    sym = pb._pb2
    handlers = {}
    for m in pb.SERVICE.methods:
        req_cls = getattr(sym, m.input_type.name)
        resp_cls = getattr(sym, m.output_type.name)
        fn = getattr(servicer, m.name)
        make = (grpc.unary_stream_rpc_method_handler if m.server_streaming
                else grpc.unary_unary_rpc_method_handler)
        handlers[m.name] = make(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(pb.SERVICE_NAME, handlers),))
