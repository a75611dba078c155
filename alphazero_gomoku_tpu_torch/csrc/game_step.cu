// The game step of the port's two games (games/gomoku.py, games/pente.py)
// for Hopper (sm_90a), one launch for each env method a simulation calls:
//   step_kernel            step and step_safe, Gomoku and Pente
//   encode_kernel          the NHWC float32 observation, 3 or 5 planes
//   legal_mask_kernel      bool [B, A]: empty point, game not over
//   terminal_value_kernel  f32 [B]: -1 after a win, else 0
//
// It replaces no TPU kernel: the JAX package's game step is plain jnp, which
// XLA fuses into a few programs.  In PyTorch the same functions ran as 60
// (Gomoku) to 118 (Pente) small ops a simulation, and launching them set the
// host's pace in self-play (PERF.md section 5).  What bounds these kernels
// is the launch itself: at 128 lanes of 15x15 a step reads and writes 29 KB
// of boards, and the largest output, Pente's 5-plane encoding, is 576 KB, a
// fraction of a microsecond at 3.35 TB/s.  So each method is one launch, and
// every kernel is as plain as its plain version:
//   - step: one warp a lane, STEP_LANES lanes a block.  The warp copies the
//     board into shared memory (byte loads: a 15x15 board is 225 bytes, so
//     lanes start at any byte), places the stone, tests the 8 capture rays
//     on 8 threads at once (Pente), removes the captured pairs after every
//     ray has been read, walks the 4 line axes both ways on 8 threads, and
//     decides the win, the full board and the scalar fields by warp votes.
//   - encode, legal_mask: a thread an output point; terminal_value a thread
//     a lane.
// Each gives its plain version's result bit for bit (ops/game_kernels.py).
// The capture planes' k / pairs_to_win is an IEEE-rounded float division,
// as the plain version's: the source builds without fast-math flags.
//
// Built by ops/_build.py as a shared library with a plain C interface.
// Every input field is read through its lane stride (in elements), so the
// slices x[:, 0] of a node-state stack need no copy; a board's cells are
// contiguous within a lane.  Each entry point launches on the stream it is
// given and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CELLS = 512;    // the tree kernels' PUCT_MAX_ACTIONS
constexpr int STEP_LANES = 4;     // lanes (one warp each) a step block
constexpr int THREADS = 256;      // threads a block of the other kernels
constexpr unsigned FULL_MASK = 0xffffffffu;

// the capture rays in the plain step's order (games/pente.py CAPTURE_DIRS)
__constant__ int CAP_DR[8] = {1, -1, 0, 0, 1, -1, 1, -1};
__constant__ int CAP_DC[8] = {0, 0, 1, -1, 1, -1, -1, 1};
// the line axes (ops/lines.py LINE_DIRS)
__constant__ int LINE_DR[4] = {1, 0, 1, 1};
__constant__ int LINE_DC[4] = {0, 1, 1, -1};

// One batch of states: each field's pointer and lane stride in elements.
// captures (int32 [B, 2], the pair contiguous) is null for Gomoku.
struct States {
  const int8_t* board;
  long long board_stride;
  const int32_t* to_move;
  long long to_move_stride;
  const int32_t* last_action;
  long long last_action_stride;
  const int32_t* move_count;
  long long move_count_stride;
  const int32_t* winner;
  long long winner_stride;
  const uint8_t* done;
  long long done_stride;
  const int32_t* captures;
  long long captures_stride;
};

// The step's int32 outputs, field-major: to_move [B], last_action [B],
// move_count [B], winner [B], then captures [B, 2] (Pente).
__device__ __forceinline__ void write_ints(int32_t* out, int batch, int b,
                                           int32_t to_move,
                                           int32_t last_action,
                                           int32_t move_count, int32_t winner,
                                           bool pente, int32_t cap0,
                                           int32_t cap1) {
  out[b] = to_move;
  out[batch + b] = last_action;
  out[2 * batch + b] = move_count;
  out[3 * batch + b] = winner;
  if (pente) {
    out[4 * batch + 2 * b] = cap0;
    out[4 * batch + 2 * b + 1] = cap1;
  }
}

// Python's index of a two-entry axis: -1 is the last entry.  Only 0 and 1
// occur in games; the clamp keeps anything else inside the lane's pair.
__device__ __forceinline__ int pair_index(int i) {
  return min(max(i < 0 ? i + 2 : i, 0), 1);
}

// The plain step (games/gomoku.py, games/pente.py) for one lane per warp.
// With `safe`, a lane whose game is over comes out exactly as it went in
// (step_safe).  An action outside [0, A) places no stone and finds no line
// or capture (the plain version fails on one); callers pass legal actions.
__global__ void __launch_bounds__(32 * STEP_LANES)
step_kernel(States s, const void* action, long long action_stride,
            int action64, int batch, int size, int pairs_to_win, int safe,
            int8_t* __restrict__ out_board, int32_t* __restrict__ out_ints,
            uint8_t* __restrict__ out_done) {
  __shared__ int8_t boards[STEP_LANES][MAX_CELLS];
  const int t = threadIdx.x & 31;
  const int b = blockIdx.x * STEP_LANES + (threadIdx.x >> 5);
  if (b >= batch) return;  // the whole warp: no block-wide barrier follows
  const int cells = size * size;
  const bool pente = s.captures != nullptr;
  int8_t* sb = boards[threadIdx.x >> 5];
  const int8_t* src = s.board + b * s.board_stride;
  int8_t* dst = out_board + (long long)b * cells;

  const int32_t me = s.to_move[b * s.to_move_stride];
  int32_t cap0 = 0, cap1 = 0;
  if (pente) {
    cap0 = s.captures[b * s.captures_stride];
    cap1 = s.captures[b * s.captures_stride + 1];
  }
  if (safe && s.done[b * s.done_stride]) {
    for (int i = t; i < cells; i += 32) dst[i] = src[i];
    if (t == 0) {
      write_ints(out_ints, batch, b, me,
                 s.last_action[b * s.last_action_stride],
                 s.move_count[b * s.move_count_stride],
                 s.winner[b * s.winner_stride], pente, cap0, cap1);
      out_done[b] = 1;
    }
    return;
  }

  for (int i = t; i < cells; i += 32) sb[i] = src[i];
  const int32_t a =
      action64 ? (int32_t)((const long long*)action)[b * action_stride]
               : ((const int32_t*)action)[b * action_stride];
  const bool on = a >= 0 && a < cells;
  const int r = on ? a / size : 0;
  const int c = on ? a % size : 0;
  const int8_t me8 = (int8_t)me;
  const int8_t opp8 = (int8_t)(3 - me);
  __syncwarp();
  if (on && t == 0) sb[a] = me8;
  __syncwarp();

  // Pente: opp, opp, own at distance 1, 2, 3 on a ray takes the pair.  The
  // pairs of two rays never overlap and no ray's anchor is taken, so every
  // ray reads the board as placed and the removals come after.
  int pairs = 0;
  if (pente) {
    bool hit = false;
    int i1 = 0, i2 = 0;
    if (on && t < 8) {
      const int dr = CAP_DR[t], dc = CAP_DC[t];
      const int r3 = r + 3 * dr, c3 = c + 3 * dc;
      if (r3 >= 0 && r3 < size && c3 >= 0 && c3 < size) {
        i1 = a + dr * size + dc;
        i2 = a + 2 * (dr * size + dc);
        hit = sb[i1] == opp8 && sb[i2] == opp8 && sb[r3 * size + c3] == me8;
      }
    }
    pairs = __popc(__ballot_sync(FULL_MASK, hit));
    __syncwarp();
    if (hit) {
      sb[i1] = 0;
      sb[i2] = 0;
    }
    __syncwarp();
  }

  // five in a row through the stone: thread 2k walks axis k forwards, 2k+1
  // backwards, up to 4 cells each (ops/lines.py run_length_through)
  int run = 0;
  if (on && t < 8) {
    const int sign = (t & 1) ? -1 : 1;
    const int dr = LINE_DR[t >> 1] * sign, dc = LINE_DC[t >> 1] * sign;
    for (int k = 1; k < 5; ++k) {
      const int rr = r + k * dr, cc = c + k * dc;
      if (rr < 0 || rr >= size || cc < 0 || cc >= size ||
          sb[rr * size + cc] != me8)
        break;
      ++run;
    }
  }
  run += __shfl_xor_sync(FULL_MASK, run, 1);
  const bool won_line = __any_sync(FULL_MASK, t < 8 && 1 + run >= 5);

  bool empty = false;
  for (int i = t; i < cells; i += 32) {
    const int8_t v = sb[i];
    dst[i] = v;
    empty |= v == 0;
  }
  const bool full = !__any_sync(FULL_MASK, empty);

  if (t == 0) {
    const int32_t moves = s.move_count[b * s.move_count_stride] + 1;
    int32_t winner;
    bool done;
    if (pente) {
      const int mine = pair_index(me - 1);
      (mine == 0 ? cap0 : cap1) += pairs;
      const bool won = (mine == 0 ? cap0 : cap1) >= pairs_to_win || won_line;
      winner = won ? me : 0;
      done = winner != 0 || full;
    } else {
      winner = won_line ? me : 0;
      done = won_line || moves >= cells;
    }
    write_ints(out_ints, batch, b, 3 - me, a, moves, winner, pente, cap0,
               cap1);
    out_done[b] = done;
  }
}

// out [B, cells, planes]: own stones, the opponent's, ones, and with 5
// planes each side's captured pairs over pairs_to_win (side to move first)
__global__ void __launch_bounds__(THREADS)
encode_kernel(const int8_t* board, long long board_stride,
              const int32_t* to_move, long long to_move_stride,
              const int32_t* captures, long long captures_stride, int batch,
              int cells, int planes, int pairs_to_win,
              float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)batch * cells) return;
  const int b = (int)(idx / cells), i = (int)(idx % cells);
  const int8_t v = board[b * board_stride + i];
  const int32_t me = to_move[b * to_move_stride];
  const int8_t me8 = (int8_t)me;
  const int8_t opp8 = (int8_t)(3 - me8);
  float* o = out + idx * planes;
  o[0] = v == me8 ? 1.0f : 0.0f;
  o[1] = v == opp8 ? 1.0f : 0.0f;
  o[2] = 1.0f;
  if (planes == 5) {
    const int32_t* k = captures + b * captures_stride;
    const float p = (float)pairs_to_win;
    o[3] = (float)k[pair_index(me - 1)] / p;
    o[4] = (float)k[pair_index(2 - me)] / p;
  }
}

__global__ void __launch_bounds__(THREADS)
legal_mask_kernel(const int8_t* board, long long board_stride,
                  const uint8_t* done, long long done_stride, int batch,
                  int cells, uint8_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)batch * cells) return;
  const int b = (int)(idx / cells), i = (int)(idx % cells);
  out[idx] = board[b * board_stride + i] == 0 && !done[b * done_stride];
}

__global__ void __launch_bounds__(THREADS)
terminal_value_kernel(const int32_t* winner, long long winner_stride,
                      int batch, float* __restrict__ out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b < batch) out[b] = winner[b * winner_stride] == 0 ? 0.0f : -1.0f;
}

int blocks(long long n, int per_block) {
  return (int)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int game_step_launch(
    const int8_t* board, long long board_stride, const int32_t* to_move,
    long long to_move_stride, const int32_t* last_action,
    long long last_action_stride, const int32_t* move_count,
    long long move_count_stride, const int32_t* winner,
    long long winner_stride, const uint8_t* done, long long done_stride,
    const int32_t* captures, long long captures_stride, const void* action,
    long long action_stride, int action64, int batch, int size,
    int pairs_to_win, int safe, int8_t* out_board, int32_t* out_ints,
    uint8_t* out_done, void* stream) {
  if (batch < 1 || size < 1 || size * size > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  const States s{board,        board_stride,       to_move,
                 to_move_stride, last_action,      last_action_stride,
                 move_count,   move_count_stride,  winner,
                 winner_stride, done,              done_stride,
                 captures,     captures_stride};
  step_kernel<<<blocks(batch, STEP_LANES), 32 * STEP_LANES, 0,
                (cudaStream_t)stream>>>(s, action, action_stride, action64,
                                        batch, size, pairs_to_win, safe,
                                        out_board, out_ints, out_done);
  return (int)cudaGetLastError();
}

extern "C" int game_encode_launch(const int8_t* board, long long board_stride,
                                  const int32_t* to_move,
                                  long long to_move_stride,
                                  const int32_t* captures,
                                  long long captures_stride, int batch,
                                  int cells, int planes, int pairs_to_win,
                                  float* out, void* stream) {
  if (batch < 1 || cells < 1 || (planes != 3 && planes != 5) ||
      (planes == 5 && captures == nullptr))
    return (int)cudaErrorInvalidValue;
  encode_kernel<<<blocks((long long)batch * cells, THREADS), THREADS, 0,
                  (cudaStream_t)stream>>>(board, board_stride, to_move,
                                          to_move_stride, captures,
                                          captures_stride, batch, cells,
                                          planes, pairs_to_win, out);
  return (int)cudaGetLastError();
}

extern "C" int game_legal_mask_launch(const int8_t* board,
                                      long long board_stride,
                                      const uint8_t* done,
                                      long long done_stride, int batch,
                                      int cells, uint8_t* out, void* stream) {
  if (batch < 1 || cells < 1) return (int)cudaErrorInvalidValue;
  legal_mask_kernel<<<blocks((long long)batch * cells, THREADS), THREADS, 0,
                      (cudaStream_t)stream>>>(board, board_stride, done,
                                              done_stride, batch, cells, out);
  return (int)cudaGetLastError();
}

extern "C" int game_terminal_value_launch(const int32_t* winner,
                                          long long winner_stride, int batch,
                                          float* out, void* stream) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  terminal_value_kernel<<<blocks(batch, THREADS), THREADS, 0,
                          (cudaStream_t)stream>>>(winner, winner_stride,
                                                  batch, out);
  return (int)cudaGetLastError();
}
