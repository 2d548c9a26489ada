"""The paper's factored GEMM leaf and the compression plan."""
