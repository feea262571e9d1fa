"""Dataset classes.  Importing this package registers the ported ones:
so far only the synthetic dataset; the file-backed datasets of
``rpo_tpu/data/datasets`` follow."""
from . import synthetic  # noqa: F401

# the JAX package's file-backed datasets, by registry name
NOT_PORTED = (
    "Caltech101", "DescribableTextures", "EuroSAT", "FGVCAircraft", "Food101", "ImageNet",
    "ImageNetA", "ImageNetR", "ImageNetSketch", "ImageNetV2", "OxfordFlowers", "OxfordPets",
    "StanfordCars", "SUN397", "UCF101",
)
