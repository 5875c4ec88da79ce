"""flutpu.codec — the device encode path.

Where the reference delegates to off-the-shelf CPU encoders (x264 etc.), this
framework owns the encoder: colorspace conversion, scaling, 8x8 DCT and
quantization run as batched JAX programs on the device, entropy bit packing
runs there too (a Pallas kernel), and the host wraps the bitstreams (C++ fast
path in native/bitstream).
"""

from .base import VideoEncoder
from .encoder import TpuJpegEnc
from .fvc import FvcDecoder, FvcEnc, FvcEncoder
from .decoders import FvcDec, JpegDec
from .avimux import AviDemux, AviMux
from .ladder import FvcLadderEnc, Rung, encode_ladder_chunk, parse_rungs

__all__ = ["VideoEncoder", "TpuJpegEnc", "FvcDecoder", "FvcEnc",
           "FvcEncoder", "FvcDec", "JpegDec", "AviMux", "AviDemux",
           "FvcLadderEnc", "Rung", "encode_ladder_chunk", "parse_rungs"]
