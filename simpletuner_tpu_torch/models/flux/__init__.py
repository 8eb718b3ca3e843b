from .model import Flux
from .transformer import (
    DoubleStreamBlock,
    FluxConfig,
    FluxTransformer,
    SingleStreamBlock,
    make_img_ids,
    make_txt_ids,
    pack_latents,
    unpack_latents,
)
