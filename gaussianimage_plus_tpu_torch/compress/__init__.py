"""Port of ``gaussianimage_plus_tpu.compress`` (see each module); the same
public names as the JAX ``compress/__init__.py``."""

from .quantizers import (
    HybridQuantParams,
    LogQuantState,
    UniformQuantParams,
    fake_quantize_half,
    hybrid_compress,
    hybrid_decompress,
    hybrid_forward,
    hybrid_init,
    hybrid_size,
    log_compress,
    log_decompress,
    log_forward,
    ste_round,
    uniform_compress,
    uniform_decompress,
    uniform_forward,
    uniform_init,
    uniform_qrange,
)
from .residual_vq import (
    ResidualVQState,
    init_residual_vq,
    residual_vq_decode,
    residual_vq_forward,
)
from .bitstream import (
    decode_bitstream,
    deserialize_bitstream,
    serialize_bitstream,
)
from .pipeline import (
    Encoding,
    QuantConfig,
    QuantizerBundle,
    analysis_wo_ec,
    compress_wo_ec,
    decode_frame,
    decompress_wo_ec,
    init_quantizers,
    prepare_decode,
    quant_train_chunk,
    render_quantized,
)
from .trainer import QuantFitResult, encode_decode_eval, fit_image_quantized
