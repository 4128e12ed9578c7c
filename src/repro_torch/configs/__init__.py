"""Architecture configs the port serves (registered on import)."""
from repro_torch.configs import harmonia_llama31_8b  # noqa: F401
from repro_torch.configs.common import (ArchSpec, get_arch,  # noqa: F401
                                        list_archs, register)
