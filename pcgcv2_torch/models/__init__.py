from pcgcv2_torch.models.autoencoder import Decoder, Encoder
from pcgcv2_torch.models.entropy import EntropyBottleneck
from pcgcv2_torch.models.pcc import PCCModel

__all__ = ["Decoder", "Encoder", "EntropyBottleneck", "PCCModel"]
