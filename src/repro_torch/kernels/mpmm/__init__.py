"""Mixed-precision matmul (K1) and implicit-GEMM conv (K2) over packed
digit planes: kernels, plain versions, oracle and public ops."""
