// Kernel A: eval forward of an L-layer GSU stack with layer 0's input gates
// given (xg0 = the hoisted layer-0 projection, computed outside), in the
// 3-D form [T, R, G] or the units form [U, T, R, G] (one section's units,
// which share its weights), the last layer's spikes or every layer's out.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _stack_eval_xg_kernel
// (:923), called by gsu_stack_eval_pallas_xg (:997, pallas_call :1140).
//
// Per step t and layer k: pre = (k == 0 ? xg0[t] : h_{k-1} @ W_ih[k]) +
// h_k @ W_hh[k]; f = sigmoid(pre_f + b_f); c = (f c + (1 - f)(pre_c + b_c))
// * scale + shift; h_k = (c >= 0). Streams and weights are f32 or bf16;
// sums, membranes and the folded eval BN are f32; expf is the precise one.
//
// What bounds it on an H100: the bytes are xg0 read once and the spikes
// written once (zoo M's served fullband, 256 rows x 320 units, bf16,
// T = 3751: 1.2 GB, about 0.4 ms at 3.35 TB/s; the collect path's sections
// in the units form, 2048, 768 and 512 columns x 224, with every layer out:
// about 5.6 ms over its four launches), and the spike products count only
// the spikes that fired. What limits it is the chain of T dependent steps,
// each a sequence of dependent products whose weights (0.2-0.6 MB a stack
// in bf16) do not fit in one SM and are read from L2 at every step. A
// thread a unit and a block a tile of 8 rows with CUDA-core FMAs waited on
// one L2 round trip a weight, under 1 % of the bound.
//
// Design: kernel F's (gsu_stack_eval_x.cu; the kernel is gsu_eval_stack.cuh's
// with GATES = true, laid out by the same host plan, ops/gsu_kernels.
// stack_x_plan, whose staged width is G here):
//   - A block of 16 warps owns N columns (8-64), a column being one (unit,
//     row) pair taken unit-major: the fewest columns whose tiles fill the
//     card in one wave. A cluster of 2 or 4 blocks splits the gate m-tiles
//     where the block's warps would hold more than one each (the fullband's
//     320 units: 20 m-tiles), pushing spikes by distributed shared memory.
//   - The recurrent and inter-layer products on mma.sync from weights packed
//     in fragment order (stack_pack) and streamed from L2; the spikes dense
//     bf16 rows read by ldmatrix, double-buffered by step parity; the
//     membranes in shared memory. float32 streams run the same schedule on
//     the CUDA cores, each input part summed from zero in k order.
//   - xg0[t + 1]'s [N, G] slice is asked for at the start of step t, held in
//     registers and stored into the other half of a double-buffered tile
//     after layer 0's products; layer 0's accumulators start from it (in
//     xg0's own column order, through gate_unit: xg0 is never permuted on
//     the host, where the units form is several GB).
//   - The written layers' spikes go out after the step's last barrier, 8
//     units a store.
// Barriers: L a step. Nothing is summed across columns, so a column's
// arithmetic does not depend on its tile, unit or cluster: the units form
// and collect_all's last layer equal the 3-D form bit for bit, and two
// launches are bitwise equal.
#include "gsu_eval_stack.cuh"

extern "C" {

// args: xg0 [U, T, R, G] (U = 1 for the 3-D form) in the io type (bf16 when
// io_bf16, else f32), the packed weights, coef [L, 4, H] f32, out [L, U, T,
// R, H] with collect_all, else [U, T, R, H], the sizes (W = G) and the
// host's plan (StackArgs). Returns the CUDA error code of the launch (0 on
// success); cudaErrorInvalidValue for what the kernel does not take (H
// 1..512, L 1..4, G = H shared or 2H, U, R >= 1, the plan's tiles within
// 232,448 bytes).
int gsu_stack_launch(int io_bf16, const gev::StackArgs* args, void* stream) {
  return gev::launch_stack<true, false>(io_bf16, *args, stream);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
