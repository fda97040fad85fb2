"""rufus_tpu_torch — the PyTorch/CUDA port of rufus_tpu.

The JAX package (``rufus_tpu``) is the reference this port is held
against; the port imports none of it. It covers the trio pipeline up to
``stop_after="contig_align"``: k-mer counting, the ModelDist depth fit,
the subject-minus-controls subtract, the mutant-read filter, read
alignment, assembly, and contig alignment with the genotype pulls, which
return interpret's inputs. The three Pallas kernels of that path and the
aligner's batched Smith-Waterman DP are CUDA kernels written for the H100
(``csrc/*.cu``), as is the radix tool's partition.

Design notes
------------
* K-mers are packed 2 bits/base (A=0, C=1, G=2, T=3) MSB-first, as in the
  reference, but held in int64: for k <= 31 every key is below 2**62, and
  the invalid-window sentinel is INT64_MAX, which sorts last. The
  reference's uint64 layout with its all-ones sentinel appears only at the
  host boundary (``KmerTable``, the ``.npz`` files, the HashList);
  ``convert.py`` translates.
* A sample's device table holds exactly its sorted unique keys and their
  counts: it is re-sized from the kernel's unique count after every fold,
  so there is no capacity, growth or retry.
* Every entry point runs on the card unless the caller passes
  ``device="cpu"``; each kernel wrapper uses its plain PyTorch version
  only for a tensor that lies on the CPU.
"""

__version__ = "0.1.0"
