// ALE-class Breakout behind the envhost plug-in ABI — the second bundled
// plug-in game on the Pong chassis (cpp/plugins/pong/pong.cc), proving
// the socket generalizes past one game (docs/ENVHOST_PLUGIN.md).
//
// Fills the EnvPool-ALE role for Breakout
// (the reference's purejaxql/utils/atari_wrapper.py:14-72 lists its
// random/human anchors): host-side ALE-standard preprocessing — frame-skip
// 4, max-pool over the last two frames, 84x84 grayscale, 4-frame HWC
// stacking — and ALE Breakout-v5's minimal action set {NOOP, FIRE, RIGHT,
// LEFT}. Rules follow the cartridge: 6 rows x 14 columns of bricks
// scoring 7/7/4/4/1/1 top-to-bottom, 5 lives, FIRE serves the ball after
// every life, the ball accelerates with bricks cleared, and clearing the
// wall builds a second one (the episode continues, frame-capped).
//
// Two builds:
//   libehbreakout.so     — "Breakout-EH", pixel obs (84, 84, 4), CNN path
//   libehbreakout_ram.so — "BreakoutRam-EH" (-DEH_BREAKOUT_RAM), 24-float
//                          RAM-style obs (ball/paddle kinematics + brick
//                          column profile), MLP path

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {
typedef struct EhPluginVTable {
  const char* name;
  int32_t obs_dim;
  int32_t num_actions;
  int32_t obs_rank;
  int32_t obs_shape[3];
  void* (*create)(uint64_t seed);
  void (*destroy)(void* env);
  void (*reset)(void* env, float* obs);
  void (*step)(void* env, int32_t action, float* obs, float* reward,
               uint8_t* done);
} EhPluginVTable;
}

namespace {

constexpr int kW = 84, kH = 84;
constexpr int kStack = 4;
constexpr int kSkip = 4;
constexpr int kRows = 6, kCols = 14;
constexpr int kBrickW = kW / kCols;  // 6 px
constexpr int kBrickH = 3;
constexpr int kWallTop = 15;         // first brick row y
constexpr float kPaddleHalf = 6.0f;
constexpr float kPaddleSpeed = 2.0f;
constexpr float kPaddleY = 80.0f;
constexpr int kLives = 5;
constexpr int kMaxFrames = 20000;
const int kRowScore[kRows] = {7, 7, 4, 4, 1, 1};  // top to bottom

struct Breakout {
  float bx, by, bvx, bvy;
  float px;            // paddle center x
  bool in_play;        // ball served?
  uint8_t bricks[kRows][kCols];
  int lives;
  int cleared;         // bricks removed since serve-speed baseline
  int frames;
  uint64_t rng;
  float frame[2][kH * kW];
  float stack[kStack][kH * kW];

  float rnd() {
    rng ^= rng << 13;
    rng ^= rng >> 7;
    rng ^= rng << 17;
    return static_cast<float>((rng >> 11) & 0xFFFFFF) / 16777216.0f;
  }

  void rebuild_wall() { std::memset(bricks, 1, sizeof(bricks)); }

  void hold_ball() {  // ball sits on the paddle until FIRE
    in_play = false;
    bx = px;
    by = kPaddleY - 2.0f;
    bvx = bvy = 0.0f;
  }

  void serve() {
    in_play = true;
    float speed = std::min(1.0f + 0.05f * cleared, 1.8f);
    float angle = (rnd() - 0.5f) * 1.0f;  // around vertical, upward
    bvx = speed * std::sin(angle);
    bvy = -speed * std::cos(angle);
  }

  void new_game() {
    rebuild_wall();
    lives = kLives;
    cleared = 0;
    frames = 0;
    px = kW / 2.0f;
    hold_ball();
  }

  int brick_row_at(float y) const {
    int r = (static_cast<int>(y) - kWallTop) / kBrickH;
    return (y >= kWallTop && r >= 0 && r < kRows) ? r : -1;
  }

  // one internal frame; returns score gained this frame, sets *lost on
  // a life loss
  int frame_step(int move, bool fire, bool* lost) {
    *lost = false;
    px = std::clamp(px + move * kPaddleSpeed, kPaddleHalf, kW - kPaddleHalf);
    if (!in_play) {
      bx = px;  // held ball rides the paddle
      if (fire) serve();
      return 0;
    }
    int gained = 0;
    bx += bvx;
    by += bvy;
    // side walls
    if (bx < 1.0f) {
      bx = 2.0f - bx;
      bvx = -bvx;
    } else if (bx > kW - 1.0f) {
      bx = 2.0f * (kW - 1.0f) - bx;
      bvx = -bvx;
    }
    // ceiling
    if (by < 1.0f) {
      by = 2.0f - by;
      bvy = -bvy;
    }
    // bricks: hit the cell at the ball position
    int r = brick_row_at(by);
    if (r >= 0) {
      int c = std::clamp(static_cast<int>(bx) / kBrickW, 0, kCols - 1);
      if (bricks[r][c]) {
        bricks[r][c] = 0;
        gained += kRowScore[r];
        cleared += 1;
        bvy = -bvy;  // cartridge-style: vertical reflection off bricks
        // ball speeds up with wall progress
        float s = std::hypot(bvx, bvy);
        float ns = std::min(1.0f + 0.05f * cleared, 2.2f);
        bvx *= ns / s;
        bvy *= ns / s;
        bool any = false;
        for (int rr = 0; rr < kRows && !any; ++rr)
          for (int cc = 0; cc < kCols; ++cc)
            if (bricks[rr][cc]) { any = true; break; }
        if (!any) rebuild_wall();  // second wall, episode continues
      }
    }
    // paddle — crossing test, not a band test: at top ball speed
    // (2.2 px/frame) a 2 px band can be stepped over entirely, losing a
    // life with the paddle perfectly positioned (tunneling)
    if (bvy > 0 && by >= kPaddleY - 1.0f && by - bvy <= kPaddleY + 1.0f &&
        std::fabs(bx - px) <= kPaddleHalf + 1.0f) {
      float off = (bx - px) / (kPaddleHalf + 1.0f);
      float speed = std::hypot(bvx, bvy);
      float angle = off * 1.1f;  // strike offset steers the rebound
      bvx = speed * std::sin(angle);
      bvy = -speed * std::cos(angle);
      by = kPaddleY - 1.0f;
    }
    // floor: life lost
    if (by > kH + 2.0f) {
      lives -= 1;
      *lost = true;
      hold_ball();
    }
    return gained;
  }

  void render(float* buf) const {
    std::memset(buf, 0, sizeof(float) * kH * kW);
    for (int r = 0; r < kRows; ++r)
      for (int c = 0; c < kCols; ++c)
        if (bricks[r][c]) {
          float v = 0.4f + 0.1f * (kRows - r);  // brighter rows score more
          int y0 = kWallTop + r * kBrickH, x0 = c * kBrickW;
          for (int y = y0; y < y0 + kBrickH - 1; ++y)
            for (int x = x0; x < x0 + kBrickW - 1; ++x)
              buf[y * kW + x] = v;
        }
    int p0 = std::clamp(static_cast<int>(px - kPaddleHalf), 0, kW - 1);
    int p1 = std::clamp(static_cast<int>(px + kPaddleHalf), 0, kW - 1);
    int pyy = static_cast<int>(kPaddleY);
    for (int y = pyy; y <= pyy + 1 && y < kH; ++y)
      for (int x = p0; x <= p1; ++x) buf[y * kW + x] = 0.8f;
    int bx0 = std::clamp(static_cast<int>(bx) - 1, 0, kW - 1);
    int bx1 = std::clamp(static_cast<int>(bx), 0, kW - 1);
    int by0 = std::clamp(static_cast<int>(by) - 1, 0, kH - 1);
    int by1 = std::clamp(static_cast<int>(by), 0, kH - 1);
    for (int y = by0; y <= by1; ++y)
      for (int x = bx0; x <= bx1; ++x) buf[y * kW + x] = 1.0f;
  }

  void refresh_stack_frame() {
    std::memmove(stack[0], stack[1], sizeof(float) * kH * kW * (kStack - 1));
    for (int i = 0; i < kH * kW; ++i)
      stack[kStack - 1][i] = std::max(frame[0][i], frame[1][i]);
  }

  void fill_stack_from_current() {
    render(frame[0]);
    std::memcpy(frame[1], frame[0], sizeof(float) * kH * kW);
    for (int s = 0; s < kStack; ++s)
      std::memcpy(stack[s], frame[0], sizeof(float) * kH * kW);
  }

#ifdef EH_BREAKOUT_RAM
  void write_obs(float* obs) const {
    obs[0] = bx / kW;
    obs[1] = by / kH;
    obs[2] = bvx / 2.5f;
    obs[3] = bvy / 2.5f;
    obs[4] = px / kW;
    obs[5] = static_cast<float>(lives) / kLives;
    obs[6] = in_play ? 1.0f : 0.0f;
    int remaining = 0;
    for (int r = 0; r < kRows; ++r)
      for (int c = 0; c < kCols; ++c) remaining += bricks[r][c];
    obs[7] = static_cast<float>(remaining) / (kRows * kCols);
    obs[8] = static_cast<float>(frames) / kMaxFrames;
    obs[9] = (bx - px) / kW;  // ball-paddle offset, the control signal
    for (int c = 0; c < kCols; ++c) {  // brick column profile
      int n = 0;
      for (int r = 0; r < kRows; ++r) n += bricks[r][c];
      obs[10 + c] = static_cast<float>(n) / kRows;
    }
  }
#else
  void write_obs(float* obs) const {
    for (int y = 0; y < kH; ++y)
      for (int x = 0; x < kW; ++x)
        for (int s = 0; s < kStack; ++s)
          obs[(y * kW + x) * kStack + s] = stack[s][y * kW + x];
  }
#endif
};

void* bcreate(uint64_t seed) {
  Breakout* b = new Breakout();
  b->rng = seed * 2654435761ULL + 0x9E3779B97F4A7C15ULL;
  b->rnd();
  b->new_game();
  b->fill_stack_from_current();
  return b;
}

void bdestroy(void* env) { delete static_cast<Breakout*>(env); }

void breset(void* env, float* obs) {
  Breakout* b = static_cast<Breakout*>(env);
  b->new_game();
  b->fill_stack_from_current();
  b->write_obs(obs);
}

void bstep(void* env, int32_t action, float* obs, float* reward,
           uint8_t* done) {
  Breakout* b = static_cast<Breakout*>(env);
  // ALE Breakout-v5 minimal set: {NOOP, FIRE, RIGHT, LEFT}
  int move = 0;
  if (action == 2) move = +1;
  if (action == 3) move = -1;
  bool fire = action == 1;

  float r = 0.0f;
  for (int k = 0; k < kSkip; ++k) {
    bool lost = false;
    r += static_cast<float>(b->frame_step(move, fire, &lost));
    b->frames += 1;
    if (k == kSkip - 2) b->render(b->frame[0]);
    if (k == kSkip - 1) b->render(b->frame[1]);
  }
  b->refresh_stack_frame();

  bool over = b->lives <= 0 || b->frames >= kMaxFrames;
  if (over) {
    *done = 1;
    b->new_game();
    b->fill_stack_from_current();
  } else {
    *done = 0;
  }
  *reward = r;
  b->write_obs(obs);
}

}  // namespace

extern "C" int eh_plugin_get(EhPluginVTable* out) {
#ifdef EH_BREAKOUT_RAM
  out->name = "BreakoutRam-EH";
  out->obs_dim = 24;
  out->obs_rank = 1;
  out->obs_shape[0] = 24;
  out->obs_shape[1] = 0;
  out->obs_shape[2] = 0;
#else
  out->name = "Breakout-EH";
  out->obs_dim = kH * kW * kStack;
  out->obs_rank = 3;
  out->obs_shape[0] = kH;
  out->obs_shape[1] = kW;
  out->obs_shape[2] = kStack;
#endif
  out->num_actions = 4;
  out->create = bcreate;
  out->destroy = bdestroy;
  out->reset = breset;
  out->step = bstep;
  return 0;
}
