/* Native kernels for the heuristic (network-free) MCTS baseline.
 *
 * A copy of alphazero_gomoku_tpu/native/puremcts.c.  Semantics are a
 * line-for-line match of the vectorized NumPy reference in
 * ../search/pure_mcts.py (threat buckets per reference mcts_pure.py:105-116,
 * 261-289; immediate-win scan per mcts_pure.py:141-146) and are
 * differential-tested against it (tests/test_torch_port_pure_mcts.py).  The
 * NumPy path spends ~75% of a playout in tiny shifted-array ops (~3 us of
 * numpy dispatch per 225-cell op, x ~300 ops per policy evaluation); these
 * loops do the same work in a few microseconds total.
 *
 * Boards are int8 row-major, values 0 (empty) / 1 / 2.  All outputs are
 * caller-allocated.  No dependencies beyond libc; built with
 *   cc -O2 -shared -fPIC puremcts.c -o libpuremcts.so
 * by the loader in __init__.py.
 */

#include <stdint.h>

#define IN_BOUNDS(r, c, n) ((r) >= 0 && (r) < (n) && (c) >= 0 && (c) < (n))

static const int DIRS[4][2] = {{1, 0}, {0, 1}, {1, 1}, {1, -1}};

/* Run of `player` stones starting one step from (r,c) along (dr,dc),
 * capped at 4; *open_end = cell just past the run is on-board and empty. */
static inline int run_and_open(const int8_t *b, int n, int player,
                               int r, int c, int dr, int dc, int *open_end) {
    int run = 0;
    int rr = r + dr, cc = c + dc;
    while (run < 4 && IN_BOUNDS(rr, cc, n) && b[rr * n + cc] == player) {
        run++;
        rr += dr;
        cc += dc;
    }
    *open_end = (IN_BOUNDS(rr, cc, n) && b[rr * n + cc] == 0);
    return run;
}

/* Per-cell threat score of placing `player` at each cell.
 * table: 0 = gomoku buckets, 1 = pente buckets. Matches
 * pure_mcts.threat_scores exactly (computed for EVERY cell, empty or not,
 * like the NumPy whole-board version). */
void az_threat_scores(const int8_t *board, int32_t size, int32_t player,
                      int32_t table, float *out) {
    int n = size;
    for (int r = 0; r < n; r++) {
        for (int c = 0; c < n; c++) {
            float score = 0.0f;
            for (int d = 0; d < 4; d++) {
                int dr = DIRS[d][0], dc = DIRS[d][1];
                int op, om;
                int rp = run_and_open(board, n, player, r, c, dr, dc, &op);
                int rm = run_and_open(board, n, player, r, c, -dr, -dc, &om);
                int count = 1 + rp + rm;
                int opens = op + om;
                if (table == 0) { /* gomoku */
                    if (count >= 5) score += 100.0f;
                    else if (count == 4 && opens == 2) score += 50.0f;
                    else if (count == 4 && opens == 1) score += 25.0f;
                    else if (count == 3 && opens == 2) score += 10.0f;
                    else if (count == 3 && opens == 1) score += 4.0f;
                    else if (count == 2 && opens == 2) score += 2.0f;
                } else { /* pente */
                    if (count >= 5) score += 120.0f;
                    else if (count == 4 && opens >= 1) score += 60.0f;
                    else if (count == 3 && opens >= 1) score += 15.0f;
                    else if (count == 2 && opens >= 1) score += 4.0f;
                }
            }
            out[r * n + c] = score;
        }
    }
}

/* Pattern me-opp-opp-me along the 4 positive rays only (the reference's
 * prior heuristic, mcts_pure.py:277-289). */
void az_capture_potential(const int8_t *board, int32_t size, int32_t player,
                          int32_t *out) {
    int n = size, opp = 3 - player;
    for (int r = 0; r < n; r++) {
        for (int c = 0; c < n; c++) {
            int pot = 0;
            for (int d = 0; d < 4; d++) {
                int dr = DIRS[d][0], dc = DIRS[d][1];
                int r3 = r + 3 * dr, c3 = c + 3 * dc;
                if (IN_BOUNDS(r3, c3, n)
                    && board[(r + dr) * n + (c + dc)] == opp
                    && board[(r + 2 * dr) * n + (c + 2 * dc)] == opp
                    && board[r3 * n + c3] == player)
                    pot++;
            }
            out[r * n + c] = pot;
        }
    }
}

/* TRUE per-cell number of pairs `player` would capture (all 8 rays). */
void az_capture_count_all(const int8_t *board, int32_t size, int32_t player,
                          int32_t *out) {
    int n = size, opp = 3 - player;
    for (int r = 0; r < n; r++) {
        for (int c = 0; c < n; c++) {
            int pot = 0;
            for (int d = 0; d < 4; d++) {
                for (int s = 0; s < 2; s++) {
                    int dr = s ? -DIRS[d][0] : DIRS[d][0];
                    int dc = s ? -DIRS[d][1] : DIRS[d][1];
                    int r3 = r + 3 * dr, c3 = c + 3 * dc;
                    if (IN_BOUNDS(r3, c3, n)
                        && board[(r + dr) * n + (c + dc)] == opp
                        && board[(r + 2 * dr) * n + (c + 2 * dc)] == opp
                        && board[r3 * n + c3] == player)
                        pot++;
                }
            }
            out[r * n + c] = pot;
        }
    }
}

/* Cells where `player` wins by playing there NOW: completes >=5 in a row,
 * or (captures_needed >= 0, Pente) captures enough pairs to reach the
 * threshold.  out is 0/1 over EMPTY cells only, like
 * pure_mcts.winning_cells. */
void az_winning_cells(const int8_t *board, int32_t size, int32_t player,
                      int32_t captures_needed, uint8_t *out) {
    int n = size;
    for (int r = 0; r < n; r++) {
        for (int c = 0; c < n; c++) {
            int idx = r * n + c;
            out[idx] = 0;
            if (board[idx] != 0) continue;
            int win = 0;
            for (int d = 0; d < 4 && !win; d++) {
                int dr = DIRS[d][0], dc = DIRS[d][1];
                int op, om;
                int rp = run_and_open(board, n, player, r, c, dr, dc, &op);
                int rm = run_and_open(board, n, player, r, c, -dr, -dc, &om);
                win = (1 + rp + rm) >= 5;
            }
            if (!win && captures_needed >= 0) {
                int need = captures_needed < 0 ? 0 : captures_needed;
                int pot = 0, opp = 3 - player;
                for (int d = 0; d < 4; d++) {
                    for (int s = 0; s < 2; s++) {
                        int dr = s ? -DIRS[d][0] : DIRS[d][0];
                        int dc = s ? -DIRS[d][1] : DIRS[d][1];
                        int r3 = r + 3 * dr, c3 = c + 3 * dc;
                        if (IN_BOUNDS(r3, c3, n)
                            && board[(r + dr) * n + (c + dc)] == opp
                            && board[(r + 2 * dr) * n + (c + 2 * dc)] == opp
                            && board[r3 * n + c3] == player)
                            pot++;
                    }
                }
                win = pot >= need;
            }
            out[idx] = (uint8_t)win;
        }
    }
}

/* Fused heuristic policy scores: 2*attack + 1.5*defense (+ 60*capture
 * potential for pente) — the center-bias term is added host-side (it is a
 * constant per board size).  One call replaces two az_threat_scores plus
 * az_capture_potential. */
void az_policy_scores(const int8_t *board, int32_t size, int32_t player,
                      int32_t table, float *out) {
    if (size > 32) return; /* stack scratch below is 32x32; caller gates */
    int n = size, opp = 3 - player;
    az_threat_scores(board, n, player, table, out);
    for (int i = 0; i < n * n; i++) out[i] *= 2.0f;
    float tmp[32 * 32];
    az_threat_scores(board, n, opp, table, tmp);
    for (int i = 0; i < n * n; i++) out[i] += 1.5f * tmp[i];
    if (table == 1) {
        int32_t cap[32 * 32];
        az_capture_potential(board, n, player, cap);
        for (int i = 0; i < n * n; i++) out[i] += 60.0f * (float)cap[i];
    }
}
