"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no
sparsity), at its full power limit of 700 W. A share against them is
stated with the card's power limit beside it."""

PEAKS = {
    # operations a second by the type of the operands
    "float32": 495e12,      # TF32 on the tensor cores: the fastest rate
                            # at which the card takes f32 operands
    "bfloat16": 989e12,
    "hbm_bytes": 3.35e12,   # bytes a second of device memory
}


def bound_s(flop: float, byts: float, dtype: str = "float32") -> float:
    """The least time the card could take: the larger of the operations
    over the peak of ``dtype`` and the bytes over the memory's."""
    return max(flop / PEAKS[dtype], byts / PEAKS["hbm_bytes"])
