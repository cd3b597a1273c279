"""Message module of the backend proto (counterpart of
localai_tpu/backend/pb.py). The generated module is imported
package-relative — never through sys.path as a top-level `backend_pb2` —
so a process holding both packages cannot pick up the reference's module
in place of this one."""
from localai_tpu_torch.backend.backend_pb2 import *  # noqa: F401,F403
from localai_tpu_torch.backend import backend_pb2 as _pb2

DESCRIPTOR = _pb2.DESCRIPTOR
SERVICE = DESCRIPTOR.services_by_name["Backend"]
SERVICE_NAME = SERVICE.full_name
