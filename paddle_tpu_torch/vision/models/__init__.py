"""The port's vision zoo (counterpart of ``paddle_tpu/vision/models``):
every CNN family of the JAX package's zoo, with the same constructors,
layer names and weight layouts, so :func:`vision_state_dict_from_jax`
carries a JAX model's weights across.  Every constructor takes
``device=`` (None: the card; ``"cpu"`` for the CPU) and ``generator=``
(the ``torch.Generator`` the initializers draw from).  Besides the CNN
families: ViT (``vit_b_16``, ``vit_l_16``; multi-resolution through a
resized position table) and the PP-YOLOE detector (``ppyoloe_crn_s``,
``ppyoloe_tiny``; its NMS is ``vision.ops``)."""

from ._convert import state_dict_from_jax, vision_state_dict_from_jax
from ._utils import ConvNormAct, make_divisible
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201, densenet264)
from .googlenet import GoogLeNet, googlenet
from .inceptionv3 import InceptionV3, inception_v3
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .mobilenetv3 import (MobileNetV3Large, MobileNetV3Small,
                          mobilenet_v3_large, mobilenet_v3_small)
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_32x8d, resnext101_64x4d, resnext152_32x4d,
                     resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_swish,
                           shufflenet_v2_x0_5, shufflenet_v2_x0_25,
                           shufflenet_v2_x0_33, shufflenet_v2_x1_0,
                           shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .ppyoloe import (CSPPAN, PPYOLOE, CSPResNet, PPYOLOEHead,
                      ppyoloe_crn_s, ppyoloe_tiny)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .vision_transformer import VisionTransformer, vit_b_16, vit_l_16

__all__ = [
    "state_dict_from_jax", "vision_state_dict_from_jax", "ConvNormAct",
    "make_divisible",
    "LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
    "resnet34", "resnet50", "resnet101", "resnet152", "resnext50_32x4d",
    "resnext50_64x4d", "resnext101_32x4d", "resnext101_32x8d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2", "VGG", "vgg11", "vgg13",
    "vgg16", "vgg19", "MobileNetV1", "mobilenet_v1", "MobileNetV2",
    "mobilenet_v2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v3_small", "mobilenet_v3_large", "ShuffleNetV2",
    "shufflenet_v2_x0_25", "shufflenet_v2_x0_33", "shufflenet_v2_x0_5",
    "shufflenet_v2_x1_0", "shufflenet_v2_x1_5", "shufflenet_v2_x2_0",
    "shufflenet_v2_swish", "SqueezeNet", "squeezenet1_0", "squeezenet1_1",
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264", "GoogLeNet", "googlenet", "InceptionV3", "inception_v3",
    "AlexNet", "alexnet", "VisionTransformer", "vit_b_16", "vit_l_16",
    "PPYOLOE", "CSPResNet", "CSPPAN", "PPYOLOEHead", "ppyoloe_crn_s",
    "ppyoloe_tiny"]
