"""Config registry of the port: importing this package registers every ported
architecture (the dense decoders granite-3-8b and chatglm3-6b; the other
families' configs come with their models) beside the paper's regression
workloads (``paper_lsq``)."""
from repro_torch.configs.base import ArchConfig, ShapeSpec, SHAPES, get_config, list_archs, shape_applicable
from repro_torch.configs import chatglm3_6b, granite_3_8b, paper_lsq

PORTED = ["chatglm3-6b", "granite-3-8b"]
