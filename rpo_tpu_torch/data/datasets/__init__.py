"""Dataset classes.  Importing this package registers all of them: the
paper's fifteen file-backed datasets, copies of ``rpo_tpu/data/datasets``
(the reference's datasets/), and the synthetic one."""
from . import caltech101  # noqa: F401
from . import dtd  # noqa: F401
from . import eurosat  # noqa: F401
from . import fgvc_aircraft  # noqa: F401
from . import food101  # noqa: F401
from . import imagenet  # noqa: F401
from . import imagenet_variants  # noqa: F401
from . import oxford_flowers  # noqa: F401
from . import oxford_pets  # noqa: F401
from . import stanford_cars  # noqa: F401
from . import sun397  # noqa: F401
from . import synthetic  # noqa: F401
from . import ucf101  # noqa: F401
