"""tpu_debruijn: a data-parallel De Bruijn graph engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``10XGenomics/rust-debruijn``.

Instead of the reference's hash maps and branchy pointer-chasing loops
(``src/filter.rs``, ``src/compression.rs``), this engine uses:

* 2-bit packed kmers in ``uint32`` limb vectors (``kmer.py``)
* sort-based joins + segmented reductions for kmer counting (``filter.py``)
* iterative pointer-doubling for unitig path compression (``compress.py``)
* a vectorized minimizer scanner for MSP sharding (``msp.py``)
* ``jax.sharding`` meshes + collectives for multi-chip scale (``parallel/``)

Layout (maps onto the reference's layer map, see SURVEY.md section 1):

* L0/L1: ``bases.py``, ``exts.py``   (lib.rs base codes, Exts, Dir)
* L2:    ``kmer.py``, ``dna.py``     (kmer.rs, dna_string.rs, vmer.rs)
* L3:    ``msp.py``, ``filter.py``   (msp.rs, filter.rs)
* L4:    ``compress.py``, ``graph.py`` (compression.rs, graph.rs)
* L5:    ``clean.py``, ``neighbors.py`` (graph walks live on DebruijnGraph)
* io:    ``io/``                     (native C++ codec, FASTA/FASTQ, exports)
* dist:  ``parallel/``               (MSP-bucket mesh; all_to_all exchange)
* test oracle: ``oracle/``           (plain-Python reference reimplementation)
"""

from tpu_debruijn import bases
from tpu_debruijn.bases import (
    base_to_bits,
    bits_to_ascii,
    bits_to_base,
    complement,
    dna_only_base_to_bits,
    is_valid_base,
)
from tpu_debruijn.compress import (
    CompressionSpec,
    ScmapCompress,
    SimpleCompress,
    compress_kmers,
    compress_kmers_color_sets,
    compress_kmers_no_exts,
    compress_kmers_rich,
)
from tpu_debruijn.dna import DnaSeq, DnaSeqBuilder, PackedSeqSet, SeqSlice
from tpu_debruijn.exts import Dir, Exts
from tpu_debruijn.kmer import KmerSpec

__version__ = "0.1.0"
