from vista_tpu_torch.engine.engine import EngineConfig, VistaEngine  # noqa: F401
from vista_tpu_torch.engine.rollout import RolloutConfig, autoregressive_rollout  # noqa: F401
from vista_tpu_torch.engine.reward import estimate_reward  # noqa: F401
