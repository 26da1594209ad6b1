// Kernel F: eval forward of an L-layer GSU stack from the raw features, the
// layer-0 input projection computed inside the kernel, every layer's spikes
// written out.
//
// Replaces spiking_fullsubnet_tpu/ops/gsu_pallas.py: _stack_eval_kernel
// (:756), called by gsu_stack_eval_pallas (:805, pallas_call :880).
//
// Per step t and layer k: pre = (k == 0 ? x[t] @ W_ih0 : h_{k-1} @ W_ih[k])
// + h_k @ W_hh[k]; f = sigmoid(pre_f + b_f); c = (f c + (1 - f)(pre_c + b_c))
// * scale + shift; h_k = (c >= 0). Streams and weights are f32 or bf16;
// sums, membranes and the folded eval BN are f32; expf is the precise one.
//
// What bounds it on an H100: at zoo M's layered forward (bf16, 256 x 30 s,
// T = 3751) the four launches (fullband 256 rows x 64 features -> 2 x 320;
// sections 2048 x 38, 768 x 94, 512 x 158 -> 2 x 224) move about 14 GB,
// almost all of it the collected spikes [L, T, R, H] (about 4 ms at
// 3.35 TB/s), and need a few hundred GOP once the spike products count only
// the spikes that fired. What limits it is the chain of T dependent steps,
// each a sequence of dependent products whose weights (0.3-0.6 MB a stack
// in bf16) are read from L2 at every step: PR 1's design (a thread a unit,
// a block a tile of 8 rows) waited on one L2 round trip a weight.
//
// Design (the host's plan, ops/gsu_kernels.stack_x_plan, sets the tile,
// the cluster and every shared-memory offset; gsu_eval_mma.cuh is the
// engine, shared with kernel B; the kernel is gsu_eval_stack.cuh's, shared
// with kernel A, which is given layer 0's gates in place of x):
//   - A block owns N rows (8-64 columns): the fewest that let the row tiles
//     fill the card in one wave. Where the tiles leave SMs idle and a
//     block's 16 warps have more than one gate m-tile each (the fullband's
//     320 units, cIRM-GSN's 256 rows), a cluster of 2 or 4 blocks splits the
//     m-tiles: each block pushes its new spikes into every block of the
//     cluster (distributed shared memory) and one cluster barrier a layer
//     orders them.
//   - Every product on the tensor cores (bf16; float32 on the CUDA cores in
//     k order): the layer-0 product x[t] W_ih0 with the dense features as
//     the right operand, the recurrent and inter-layer products with the
//     spikes as dense bf16 rows in shared memory (one ldmatrix gives a
//     warp two n-groups' fragments); weights packed in fragment order
//     (stack_x_pack) and streamed from L2, two batches of tiles in flight a
//     warp.
//   - x[t + 1] is asked for at the start of step t, held in registers and
//     stored into the other half of a double-buffered tile after layer 0's
//     products, so its round trip is off the chain.
//   - The spikes of every layer go out after the step's last barrier, 8
//     units (16 or 32 bytes) a store, whole rows of H: the stores leave the
//     chain, which never waits on them.
// Barriers: L a step (one after each layer). Rows are independent: a row's
// arithmetic does not depend on the tile or the cluster, and nothing is
// summed across threads, so two launches are bitwise equal.
#include "gsu_eval_stack.cuh"

extern "C" {

// args: the streams, the packed weights, the sizes and the host's plan
// (StackArgs, U = 1, collect_all = 1). Returns the CUDA error code of the
// launch (0 on success); cudaErrorInvalidValue for what the kernel does not
// take (H 1..512, L 1..4, F 1..1024, R >= 1, the plan's tiles within
// 232,448 bytes).
int gsu_stack_launch(int io_bf16, const gev::StackArgs* args, void* stream) {
  return gev::launch_stack<false>(io_bf16, *args, stream);
}

const char* gsu_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
