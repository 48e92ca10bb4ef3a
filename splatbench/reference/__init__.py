"""The plain PyTorch reference that decides ``correct``: ``raster`` (the
renderer and its gradient) and ``train`` (the loss and Adam). It imports
neither JAX nor anything of the system under test, and works out again
from the benchmark's inputs whatever the system derives from them."""
