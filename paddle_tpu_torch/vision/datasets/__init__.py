"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets``).

MNIST, FashionMNIST and Cifar10/100 read their files where present
(the same formats as upstream) and otherwise fall back to the JAX
package's deterministic synthetic data, made by the same
``np.random.RandomState(seed)`` code so the arrays are identical across
the packages.  ``PADDLE_TORCH_SYNTH_N`` sets the fallback's size.
Nothing is ever downloaded.  ``__getitem__`` returns ``(CHW float32
array, int64 array of shape [1])``.
"""

from .cifar import Cifar10, Cifar100
from .mnist import MNIST, FashionMNIST
from .synthetic import SyntheticImages

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "SyntheticImages"]
