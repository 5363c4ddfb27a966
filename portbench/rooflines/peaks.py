"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
at the 700 W power limit) and the per-clock rates of its SMs that the
rooflines use (the CUDA C++ Programming Guide's throughput table for
compute capability 9.0)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores, a fused multiply-add counted as 2
SMS, BOOST_HZ = 132, 1.98e9
INT32_OPS_PER_S = SMS * 64 * BOOST_HZ  # 32-bit integer add / logic: 64 a clock an SM
POPC_PER_S = SMS * 16 * BOOST_HZ  # 32-bit population count: 16 a clock an SM
