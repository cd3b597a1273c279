from localai_tpu_torch.engine.loader import (  # noqa: F401
    load_config, load_model, load_params,
)
from localai_tpu_torch.engine.tokenizer import Tokenizer  # noqa: F401
from localai_tpu_torch.engine.engine import (  # noqa: F401
    Engine,
    EngineConfig,
    GenRequest,
    StepOutput,
)
