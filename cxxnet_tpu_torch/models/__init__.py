"""Model zoo: conf-text builders.

Counterpart of ``cxxnet_tpu/models``: each builder returns the conf
text of one network in the reference's grammar (feed it to
``config.parse_pairs`` or write it to a file for the CLI), equal to the
JAX package's builder's text.
"""

from .builders import (  # noqa: F401
    alexnet_conf,
    googlenet_conf,
    kaggle_bowl_conf,
    mnist_conv_conf,
    mnist_mlp_conf,
    resnet50_conf,
    resnet101_conf,
    resnet152_conf,
    transformer_conf,
    transformer_lm_conf,
    vgg16_conf,
    vgg19_conf,
)

MODEL_BUILDERS = {
    "mnist_mlp": mnist_mlp_conf,
    "mnist_conv": mnist_conv_conf,
    "alexnet": alexnet_conf,
    "googlenet": googlenet_conf,
    "vgg16": vgg16_conf,
    "vgg19": vgg19_conf,
    "resnet50": resnet50_conf,
    "resnet101": resnet101_conf,
    "resnet152": resnet152_conf,
    "kaggle_bowl": kaggle_bowl_conf,
    "transformer": transformer_conf,
    "transformer_lm": transformer_lm_conf,
}
