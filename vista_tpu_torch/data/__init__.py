from vista_tpu_torch.data.datasets import (  # noqa: F401
    BaseVideoDataset,
    DatasetConfig,
    NuScenesDataset,
    SyntheticVideoDataset,
    YouTubeFramesDataset,
)
from vista_tpu_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    DataPipeline,
    MultiSourceSampler,
    PipelineConfig,
    SourceConfig,
    build_pipeline,
)
