"""Hub-style constructors of the port (the twin of the repository's root
`hubconf.py`): one call builds a bottleneck-injected classifier or
detector, with the same names, arguments and defaults as the root
module's, as an initialized `nn.Module` on `device` (CUDA unless asked
otherwise; `device='cpu'` or `'meta'` to build elsewhere).

    from sc2bench_tpu_torch import hubconf
    model = hubconf.custom_resnet50(bottleneck_channel=12, device='cuda')

or, through `torch.hub` from the checkout's root,
`torch.hub.load('sc2bench_tpu_torch', 'custom_resnet50', source='local')`.

As in the root module (and unlike the reference's):
  - `custom_inception_v3` returns the `inception_v3_bottleneck` layer
    alone, not a classifier;
  - `custom_resnet_fpn_backbone` returns the pair (backbone body, FPN),
    with `FrozenBatchNorm2d` in the body's stages by default;
  - the R-CNN constructors put `larger_resnet_layer1_bottleneck` on the
    raw image in place of the stem and layer1: every conv of that
    bottleneck is at stride 1, so C2 comes out at stride 1 with 256
    channels (the full image size).
The weights are fresh: the reference's pretrained ones are not in the
repository.
"""
from sc2bench_tpu_torch.device import resolve_device
from sc2bench_tpu_torch.models.backbone import (DENSENET_BLOCKS,
                                                STAGE_SIZES,
                                                SplittableDenseNet,
                                                SplittableResNet)
from sc2bench_tpu_torch.models.layer import get_layer

dependencies = ['torch']
# the stage sizes each detection constructor accepts, as the root module's
_FPN_STAGES = {f'custom_{n}': STAGE_SIZES[n]
               for n in ('resnet50', 'resnet101', 'resnet152')}
_RCNN_STAGES = {n: STAGE_SIZES[n] for n in ('resnet50', 'resnet101')}


def _bottleneck(bottleneck_channel, bottleneck_idx, builder):
    return get_layer(builder, bottleneck_channel=bottleneck_channel,
                     bottleneck_idx=bottleneck_idx)


def _resnet(name, bottleneck_channel, bottleneck_idx, num_classes, device):
    dev = resolve_device(device)
    return SplittableResNet(
        _bottleneck(bottleneck_channel, bottleneck_idx,
                    'larger_resnet_bottleneck'),
        stage_sizes=STAGE_SIZES[name], num_classes=num_classes).to(dev)


def custom_resnet50(bottleneck_channel=12, bottleneck_idx=7,
                    num_classes=1000, device=None, **kwargs):
    """GHND bottleneck-injected ResNet-50."""
    return _resnet('resnet50', bottleneck_channel, bottleneck_idx,
                   num_classes, device)


def custom_resnet101(bottleneck_channel=12, bottleneck_idx=7,
                     num_classes=1000, device=None, **kwargs):
    return _resnet('resnet101', bottleneck_channel, bottleneck_idx,
                   num_classes, device)


def custom_resnet152(bottleneck_channel=12, bottleneck_idx=7,
                     num_classes=1000, device=None, **kwargs):
    return _resnet('resnet152', bottleneck_channel, bottleneck_idx,
                   num_classes, device)


def _densenet(name, bottleneck_channel, bottleneck_idx, num_classes,
              device):
    dev = resolve_device(device)
    return SplittableDenseNet(
        _bottleneck(bottleneck_channel, bottleneck_idx,
                    'larger_densenet_bottleneck'),
        block_config=DENSENET_BLOCKS[name], num_classes=num_classes).to(dev)


def custom_densenet169(bottleneck_channel=12, bottleneck_idx=8,
                       num_classes=1000, device=None, **kwargs):
    return _densenet('densenet169', bottleneck_channel, bottleneck_idx,
                     num_classes, device)


def custom_densenet201(bottleneck_channel=12, bottleneck_idx=8,
                       num_classes=1000, device=None, **kwargs):
    return _densenet('densenet201', bottleneck_channel, bottleneck_idx,
                     num_classes, device)


def custom_inception_v3(bottleneck_channel=12, bottleneck_idx=7,
                        num_classes=1000, device=None, **kwargs):
    """The `inception_v3_bottleneck` layer alone (module doc)."""
    dev = resolve_device(device)
    return _bottleneck(bottleneck_channel, bottleneck_idx,
                       'inception_v3_bottleneck').to(dev)


def custom_resnet_fpn_backbone(backbone_key='custom_resnet50', layer1=None,
                               frozen_bn=True, device=None, **kwargs):
    """(backbone body, FPN): the layer1-replacing bottleneck (`layer1`,
    the kwargs of `larger_resnet_layer1_bottleneck`) and the ResNet
    stages of `backbone_key`, and a 256-channel FPN over [C2 ... C5]."""
    from sc2bench_tpu_torch.models.detection.base import \
        SplittableDetectionBackbone
    from sc2bench_tpu_torch.models.detection.fpn import FeaturePyramidNetwork
    dev = resolve_device(device)
    body = SplittableDetectionBackbone(
        get_layer('larger_resnet_layer1_bottleneck', **(layer1 or {})),
        stage_sizes=_FPN_STAGES[backbone_key],
        frozen_bn=frozen_bn)
    fpn = FeaturePyramidNetwork(body.out_channels_list, out_channels=256)
    return body.to(dev), fpn.to(dev)


def _rcnn(cls, backbone, bottleneck_channel, bottleneck_idx, device,
          **kwargs):
    from sc2bench_tpu_torch.models.detection.base import \
        SplittableDetectionBackbone
    stage_sizes = _RCNN_STAGES[backbone]
    dev = resolve_device(device)
    body = SplittableDetectionBackbone(
        _bottleneck(bottleneck_channel, bottleneck_idx,
                    'larger_resnet_layer1_bottleneck'),
        stage_sizes=stage_sizes)
    return cls(body, **kwargs).to(dev)


def custom_fasterrcnn_resnet_fpn(backbone='resnet50', bottleneck_channel=12,
                                 bottleneck_idx=8, num_classes=91,
                                 device=None, **kwargs):
    """Faster R-CNN over the layer1-replacing bottleneck (module doc)."""
    from sc2bench_tpu_torch.models.detection.rcnn import FasterRCNN
    return _rcnn(FasterRCNN, backbone, bottleneck_channel, bottleneck_idx,
                 device, num_classes=num_classes)


def custom_maskrcnn_resnet_fpn(backbone='resnet50', bottleneck_channel=12,
                               bottleneck_idx=8, num_classes=91, device=None,
                               **kwargs):
    from sc2bench_tpu_torch.models.detection.rcnn import MaskRCNN
    return _rcnn(MaskRCNN, backbone, bottleneck_channel, bottleneck_idx,
                 device, num_classes=num_classes)


def custom_keypointrcnn_resnet_fpn(backbone='resnet50', bottleneck_channel=12,
                                   bottleneck_idx=8, num_classes=2,
                                   num_keypoints=17, device=None, **kwargs):
    from sc2bench_tpu_torch.models.detection.rcnn import KeypointRCNN
    return _rcnn(KeypointRCNN, backbone, bottleneck_channel, bottleneck_idx,
                 device, num_classes=num_classes,
                 num_keypoints=num_keypoints)
