"""Plain PyTorch stages of the pipeline, and the twins of the CUDA kernels.

    eigh3x3    -- batched closed-form 3x3 eigensolve
    cellstats  -- cell moments (twin of csrc/cellstats.cu), gates, plane fits
    histogram  -- spherical normals histogram bins
    growing    -- rounds loop (twin of csrc/growing.cu), region sums, finalize
    merge      -- adjacency, greedy merge (twin of csrc/merge.cu), labels
"""
