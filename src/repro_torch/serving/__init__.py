from .engine import Engine, ServeCfg  # noqa: F401
from .gateway import (CatalogEntry, EdgeGateway, ServedResult,  # noqa: F401
                      toy_diffusion_builder)
