"""Layer tables for the paper's own workloads: ResNet-50, VGG-16, GoogleNet.

The paper's headline numbers (1.8-2.2x exposed-comm reduction from message
prioritization; ResNet-50 90% scaling at 256 nodes, Fig. 2) are measured on
these CNNs; the benchmark harness feeds these tables into the C2C model and
the discrete-event simulator. Channel/shape specs follow the original
architectures (He et al. 2015; Simonyan & Zisserman 2014; Szegedy et al.
2014) at 224x224 ImageNet resolution.

A copy of `repro/configs/cnn_tables.py` over the port's `core/c2c.py` (itself
equal to the reference's), so that port benchmarks and tests read the tables
without JAX; `tests/test_torch_configs.py` holds the two equal.
"""

from __future__ import annotations

from repro_torch.core import c2c


def resnet50_layers():
    L = [c2c.conv_layer("conv1", 3, 64, 7, 112, 112)]
    # (blocks, in_ch, mid_ch, out_ch, spatial)
    stages = [(3, 64, 64, 256, 56), (4, 256, 128, 512, 28),
              (6, 512, 256, 1024, 14), (3, 1024, 512, 2048, 7)]
    for si, (blocks, cin, mid, cout, hw_) in enumerate(stages):
        for b in range(blocks):
            i = cin if b == 0 else cout
            pre = f"res{si+2}{chr(ord('a')+b)}"
            L.append(c2c.conv_layer(f"{pre}_1x1a", i, mid, 1, hw_, hw_))
            L.append(c2c.conv_layer(f"{pre}_3x3", mid, mid, 3, hw_, hw_))
            L.append(c2c.conv_layer(f"{pre}_1x1b", mid, cout, 1, hw_, hw_))
            if b == 0:
                L.append(c2c.conv_layer(f"{pre}_proj", i, cout, 1, hw_, hw_))
    L.append(c2c.fc_layer("fc1000", 2048, 1000))
    return L


def vgg16_layers():
    spec = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
            (128, 256, 56), (256, 256, 56), (256, 256, 56),
            (256, 512, 28), (512, 512, 28), (512, 512, 28),
            (512, 512, 14), (512, 512, 14), (512, 512, 14)]
    L = [c2c.conv_layer(f"conv{i+1}", cin, cout, 3, hw_, hw_)
         for i, (cin, cout, hw_) in enumerate(spec)]
    L.append(c2c.fc_layer("fc6", 512 * 7 * 7, 4096))
    L.append(c2c.fc_layer("fc7", 4096, 4096))
    L.append(c2c.fc_layer("fc8", 4096, 1000))
    return L


# GoogleNet (Inception v1) module channel table:
# (name, spatial, in, 1x1, 3x3red, 3x3, 5x5red, 5x5, poolproj)
_INCEPTION = [
    ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
    ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
    ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
    ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
    ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
    ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
    ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
    ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
    ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
]


def googlenet_layers():
    L = [c2c.conv_layer("conv1", 3, 64, 7, 112, 112),
         c2c.conv_layer("conv2red", 64, 64, 1, 56, 56),
         c2c.conv_layer("conv2", 64, 192, 3, 56, 56)]
    for (name, hw_, cin, c1, c3r, c3, c5r, c5, cp) in _INCEPTION:
        L.append(c2c.conv_layer(f"inc{name}_1x1", cin, c1, 1, hw_, hw_))
        L.append(c2c.conv_layer(f"inc{name}_3x3r", cin, c3r, 1, hw_, hw_))
        L.append(c2c.conv_layer(f"inc{name}_3x3", c3r, c3, 3, hw_, hw_))
        L.append(c2c.conv_layer(f"inc{name}_5x5r", cin, c5r, 1, hw_, hw_))
        L.append(c2c.conv_layer(f"inc{name}_5x5", c5r, c5, 5, hw_, hw_))
        L.append(c2c.conv_layer(f"inc{name}_pool", cin, cp, 1, hw_, hw_))
    L.append(c2c.fc_layer("fc1000", 1024, 1000))
    return L


TOPOLOGIES = {"resnet50": resnet50_layers, "vgg16": vgg16_layers,
              "googlenet": googlenet_layers}
