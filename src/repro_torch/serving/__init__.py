from .gateway import (CatalogEntry, EdgeGateway, ServedResult,  # noqa: F401
                      toy_diffusion_builder)
