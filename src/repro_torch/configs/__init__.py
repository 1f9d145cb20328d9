"""Model configurations of the port: the paper's TM zoo
(``configs.imbue_tm``) and the registry of the ten LM architectures —
importing this package registers them (``configs.archs``), as the
reference's does."""
from repro_torch.configs import archs  # noqa: F401  (registration side-effect)
from repro_torch.configs.base import get_config, list_archs, smoke  # noqa: F401
