from .specs import ConvLayer, StageSpec, decoder_spec, encoder_spec
from .vgg import Decoder, Encoder, apply_decoder, apply_encoder, init_params
from .zoo import load_pyramid, load_stage_params, stage_specs
