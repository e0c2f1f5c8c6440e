from .mobilenet_v2 import MobileNetV2
from .resnet import ResNet, ResNet50
from .transformer import Transformer, TransformerConfig, init_kv_caches
