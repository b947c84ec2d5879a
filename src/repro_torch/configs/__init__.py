"""Config registry of the port: importing this package registers every ported
architecture (the dense decoders granite-3-8b and chatglm3-6b, gemma3-12b with
its local:global attention, the MoE models mixtral-8x7b and grok-1-314b,
minicpm3-4b with MLA, the hybrid hymba-1.5b, the attention-free Mamba stack
falcon-mamba-7b, the encoder-decoder whisper-small and the VLM pixtral-12b)
beside the paper's regression workloads (``paper_lsq``)."""
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, get_config, list_archs, shape_applicable
from repro_torch.configs import (chatglm3_6b, falcon_mamba_7b, gemma3_12b, granite_3_8b, grok_1_314b, hymba_1_5b,
                                 minicpm3_4b, mixtral_8x7b, paper_lsq, pixtral_12b, whisper_small)

PORTED = ["chatglm3-6b", "falcon-mamba-7b", "gemma3-12b", "granite-3-8b", "grok-1-314b", "hymba-1.5b", "minicpm3-4b",
          "mixtral-8x7b", "pixtral-12b", "whisper-small"]
