// Pong behind the envhost plug-in ABI (docs/ENVHOST_PLUGIN.md) — the
// bundled demonstration that the EnvPool-role socket takes a real game.
//
// Fills the role the reference gets from EnvPool's ALE Pong
// (the reference's purejaxql/pqn_atari.py:123-143): a C++ game stepped by
// the host thread pool, with the standard Atari preprocessing done HERE,
// on the host, exactly as EnvPool does it — frame-skip 4, max-pool over
// the last two frames, 84x84 grayscale, 4-frame stacking (HWC). The ALE
// action-set convention is kept too: 6 actions mapping onto
// {noop, noop, up, down, up, down} like Pong-v5's minimal set.
//
// Two builds from this source:
//   libehpong.so      — "Pong-EH", pixel obs (84, 84, 4), the CNN path
//   libehpong_ram.so  — "PongRam-EH" (-DEH_PONG_RAM), 8-float RAM-style
//                        obs, the MLP path (ALE's *-ram-v5 analogue)
//
// Game rules: first to 21 points, +1/-1 per point, serve toward the
// scored-on side with a seeded angle; right paddle is the agent, left
// paddle a capped-speed tracking opponent with a dead zone (imperfect, so
// rallies are winnable); ball speeds up on each return and its bounce
// angle depends on where it strikes the paddle. All state and randomness
// are per-instance (xorshift64 from the pool-provided seed).

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
constexpr float kPaddleHalf = 6.0f;   // px
constexpr float kPaddleSpeed = 2.0f;  // agent px/frame
constexpr float kOppSpeed = 0.70f;    // opponent px/frame (beatable)
constexpr float kOppDead = 2.0f;      // opponent tracking dead zone
constexpr int kPlayerX = 80, kOppX = 3;
constexpr int kWinScore = 21;
constexpr int kMaxFrames = 20000;  // internal frames (5000 agent steps)

struct Pong {
  // ball
  float bx, by, bvx, bvy;
  // paddles (y of center)
  float py, oy;
  int score_self, score_opp;
  int frames;
  uint64_t rng;
  // frame buffers: two most recent rendered frames (for the max-pool) and
  // the 4-frame stack of pooled frames
  float frame[2][kH * kW];
  float stack[kStack][kH * kW];

  float rnd() {  // xorshift64 -> [0, 1)
    rng ^= rng << 13;
    rng ^= rng >> 7;
    rng ^= rng << 17;
    return static_cast<float>((rng >> 11) & 0xFFFFFF) / 16777216.0f;
  }

  void serve(int toward) {  // toward: -1 left, +1 right
    bx = kW / 2.0f;
    by = kH / 2.0f;
    float angle = (rnd() - 0.5f) * 1.2f;  // radians around horizontal
    float speed = 1.1f;
    bvx = toward * speed * std::cos(angle);
    bvy = speed * std::sin(angle);
    if (std::fabs(bvy) < 0.15f) bvy = bvy < 0 ? -0.15f : 0.15f;
  }

  void new_game() {
    py = oy = kH / 2.0f;
    score_self = 0;
    score_opp = 0;
    frames = 0;
    serve(rnd() < 0.5f ? -1 : 1);
  }

  // advance one internal frame; returns the point outcome (+1/-1/0)
  int frame_step(int move) {  // move: -1 up, 0, +1 down (screen coords)
    py = std::clamp(py + move * kPaddleSpeed, kPaddleHalf,
                    kH - kPaddleHalf);
    // opponent tracks the ball with capped speed outside a dead zone
    float dy = by - oy;
    if (std::fabs(dy) > kOppDead) {
      oy += std::clamp(dy, -kOppSpeed, kOppSpeed);
      oy = std::clamp(oy, kPaddleHalf, kH - kPaddleHalf);
    }
    bx += bvx;
    by += bvy;
    if (by < 1.0f) {
      by = 2.0f - by;
      bvy = -bvy;
    } else if (by > kH - 1.0f) {
      by = 2.0f * (kH - 1.0f) - by;
      bvy = -bvy;
    }
    // paddle strikes: bounce angle follows the strike offset, ball speeds
    // up slightly on every return (capped)
    if (bvx > 0 && bx >= kPlayerX - 1.0f && bx <= kPlayerX + 1.0f) {
      if (std::fabs(by - py) <= kPaddleHalf + 1.5f) {
        float off = (by - py) / (kPaddleHalf + 1.5f);
        float speed = std::min(
            2.4f, std::hypot(bvx, bvy) * 1.05f);
        float angle = off * 1.0f;
        bvx = -speed * std::cos(angle);
        bvy = speed * std::sin(angle);
        bx = kPlayerX - 1.0f;
      }
    }
    if (bvx < 0 && bx <= kOppX + 1.0f && bx >= kOppX - 1.0f) {
      if (std::fabs(by - oy) <= kPaddleHalf + 1.5f) {
        float off = (by - oy) / (kPaddleHalf + 1.5f);
        float speed = std::min(
            2.4f, std::hypot(bvx, bvy) * 1.05f);
        float angle = off * 1.0f;
        bvx = speed * std::cos(angle);
        bvy = speed * std::sin(angle);
        bx = kOppX + 1.0f;
      }
    }
    if (bx > kW + 2.0f) {  // past the agent: opponent scores
      score_opp += 1;
      serve(+1);
      return -1;
    }
    if (bx < -2.0f) {  // past the opponent: agent scores
      score_self += 1;
      serve(-1);
      return +1;
    }
    return 0;
  }

  void render(float* buf) const {
    std::memset(buf, 0, sizeof(float) * kH * kW);
    auto draw = [&](int x0, int x1, int y0, int y1, float v) {
      x0 = std::clamp(x0, 0, kW - 1);
      x1 = std::clamp(x1, 0, kW - 1);
      y0 = std::clamp(y0, 0, kH - 1);
      y1 = std::clamp(y1, 0, kH - 1);
      for (int y = y0; y <= y1; ++y)
        for (int x = x0; x <= x1; ++x) buf[y * kW + x] = v;
    };
    int ph = static_cast<int>(kPaddleHalf);
    draw(kOppX - 1, kOppX, static_cast<int>(oy) - ph,
         static_cast<int>(oy) + ph, 0.6f);
    draw(kPlayerX, kPlayerX + 1, static_cast<int>(py) - ph,
         static_cast<int>(py) + ph, 0.8f);
    draw(static_cast<int>(bx) - 1, static_cast<int>(bx),
         static_cast<int>(by) - 1, static_cast<int>(by), 1.0f);
  }

  void refresh_stack_frame() {
    // max-pool the two most recent frames into the newest stack slot
    std::memmove(stack[0], stack[1],
                 sizeof(float) * kH * kW * (kStack - 1));
    for (int i = 0; i < kH * kW; ++i)
      stack[kStack - 1][i] = std::max(frame[0][i], frame[1][i]);
  }

  void fill_stack_from_current() {
    render(frame[0]);
    std::memcpy(frame[1], frame[0], sizeof(float) * kH * kW);
    for (int s = 0; s < kStack; ++s)
      std::memcpy(stack[s], frame[0], sizeof(float) * kH * kW);
  }

#ifdef EH_PONG_RAM
  void write_obs(float* obs) const {
    obs[0] = bx / kW;
    obs[1] = by / kH;
    obs[2] = bvx / 3.0f;
    obs[3] = bvy / 3.0f;
    obs[4] = py / kH;
    obs[5] = oy / kH;
    obs[6] = static_cast<float>(score_self - score_opp) / kWinScore;
    obs[7] = static_cast<float>(frames) / kMaxFrames;
  }
#else
  void write_obs(float* obs) const {
    // HWC: obs[y][x][c], channel = stack age (oldest first)
    for (int y = 0; y < kH; ++y)
      for (int x = 0; x < kW; ++x)
        for (int s = 0; s < kStack; ++s)
          obs[(y * kW + x) * kStack + s] = stack[s][y * kW + x];
  }
#endif
};

void* pcreate(uint64_t seed) {
  Pong* p = new Pong();
  p->rng = seed * 2654435761ULL + 0x9E3779B97F4A7C15ULL;
  p->rnd();
  p->new_game();
  p->fill_stack_from_current();
  return p;
}

void pdestroy(void* env) { delete static_cast<Pong*>(env); }

void preset(void* env, float* obs) {
  Pong* p = static_cast<Pong*>(env);
  p->new_game();
  p->fill_stack_from_current();
  p->write_obs(obs);
}

void pstep(void* env, int32_t action, float* obs, float* reward,
           uint8_t* done) {
  Pong* p = static_cast<Pong*>(env);
  // ALE Pong-v5 minimal-set convention: {NOOP, FIRE, UP, DOWN, UPFIRE,
  // DOWNFIRE} -> up is -y on screen
  int move = 0;
  if (action == 2 || action == 4) move = -1;
  if (action == 3 || action == 5) move = +1;

  float r = 0.0f;
  for (int k = 0; k < kSkip; ++k) {
    r += static_cast<float>(p->frame_step(move));
    p->frames += 1;
    if (k == kSkip - 2) p->render(p->frame[0]);
    if (k == kSkip - 1) p->render(p->frame[1]);
  }
  p->refresh_stack_frame();

  bool over = p->score_self >= kWinScore || p->score_opp >= kWinScore ||
              p->frames >= kMaxFrames;
  if (over) {
    *done = 1;
    p->new_game();
    p->fill_stack_from_current();
  } else {
    *done = 0;
  }
  *reward = r;
  p->write_obs(obs);
}

}  // namespace

extern "C" int eh_plugin_get(EhPluginVTable* out) {
#ifdef EH_PONG_RAM
  out->name = "PongRam-EH";
  out->obs_dim = 8;
  out->obs_rank = 1;
  out->obs_shape[0] = 8;
  out->obs_shape[1] = 0;
  out->obs_shape[2] = 0;
#else
  out->name = "Pong-EH";
  out->obs_dim = kH * kW * kStack;
  out->obs_rank = 3;
  out->obs_shape[0] = kH;
  out->obs_shape[1] = kW;
  out->obs_shape[2] = kStack;
#endif
  out->num_actions = 6;
  out->create = pcreate;
  out->destroy = pdestroy;
  out->reset = preset;
  out->step = pstep;
  return 0;
}
