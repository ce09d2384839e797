// envhost: a C++ batched CPU environment pool with a C ABI.
//
// The PyTorch port's own copy of the JAX package's pool
// (purejaxql_tpu/cpp/envhost/envhost.cc), the same code and the same C ABI
// (eh_make, eh_step, eh_load_plugin, EhPluginVTable), so a plug-in built
// for one pool loads into the other. It plays the role EnvPool plays in
// the reference (C++ Atari envs feeding the device learner, the
// reference's purejaxql/utils/atari_wrapper.py:100-104): environments
// whose dynamics are not device programs run on the host CPU, stepped in
// parallel by a persistent worker-thread pool, and exchange flat buffers
// with the trainer through ctypes (purejaxql_torch/envs/hostpool.py).
//
// Design:
//  - one Pool owns N environment instances and a fixed thread team;
//  - step() scatters disjoint env ranges to workers (no locks on the hot
//    path; a generation counter + condition variable coordinates rounds);
//  - envs auto-reset on termination, gymnax-style, so the learner sees an
//    infinite stream;
//  - everything crosses the ABI as flat float32/int32 buffers allocated
//    by the caller (numpy arrays on the Python side).
//
// Environments implemented natively: CartPole-v1, Acrobot-v1, and all
// five MinAtar games (Breakout, Asterix, Freeway, SpaceInvaders,
// Seaquest) with the same dynamics as the in-graph versions
// (envs/classic/*.py, envs/minatar/*.py), so the host path can be
// validated against the device path.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <dlfcn.h>
#include <functional>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ----------------------------------------------------------------------
// Plug-in ABI: external games load at runtime without recompiling the
// pool (the EnvPool-extension role; how a real ALE adapter would attach —
// see docs/ENVHOST_PLUGIN.md). A plug-in .so exposes ONE symbol:
//
//   int eh_plugin_get(EhPluginVTable* out);   // fill, return 0 on success
//
// Instances are per-env, created lazily with a seed drawn from the pool's
// per-env RNG stream; the plug-in owns all instance state and RNG.
// ----------------------------------------------------------------------
extern "C" {
typedef struct EhPluginVTable {
  const char* name;       // registry key, e.g. "Pong-ALE"
  int32_t obs_dim;        // product of obs_shape
  int32_t num_actions;
  int32_t obs_rank;       // 1..3
  int32_t obs_shape[3];
  void* (*create)(uint64_t seed);
  void (*destroy)(void* env);
  void (*reset)(void* env, float* obs);
  // Writes next obs (post-auto-reset when done), reward and done flag.
  void (*step)(void* env, int32_t action, float* obs, float* reward,
               uint8_t* done);
} EhPluginVTable;
}

namespace {

constexpr double kPi = 3.14159265358979323846;

// ----------------------------------------------------------------------
// Environment interface
// ----------------------------------------------------------------------
class Env {
 public:
  virtual ~Env() = default;
  virtual void reset(std::mt19937_64& rng, float* obs) = 0;
  // Returns (reward, done); writes next obs (post-auto-reset when done).
  virtual void step(std::mt19937_64& rng, int action, float* obs,
                    float* reward, uint8_t* done) = 0;
  virtual int obs_dim() const = 0;
  virtual int num_actions() const = 0;
  // Logical observation shape (flattened into obs_dim); rank <= 3.
  virtual std::vector<int> obs_shape() const { return {obs_dim()}; }
};

// ----------------------------------------------------------------------
// CartPole-v1 (dynamics mirror envs/classic/cartpole.py)
// ----------------------------------------------------------------------
class CartPole : public Env {
 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    std::uniform_real_distribution<double> d(-0.05, 0.05);
    x_ = d(rng); x_dot_ = d(rng); theta_ = d(rng); theta_dot_ = d(rng);
    t_ = 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    const double gravity = 9.8, masspole = 0.1, total_mass = 1.1;
    const double length = 0.5, polemass_length = 0.05, force_mag = 10.0;
    const double tau = 0.02;
    const double theta_thresh = 12.0 * 2.0 * kPi / 360.0;
    const double x_thresh = 2.4;

    bool prev_done = std::abs(x_) > x_thresh ||
                     std::abs(theta_) > theta_thresh || t_ >= 500;

    double force = action == 1 ? force_mag : -force_mag;
    double costh = std::cos(theta_), sinth = std::sin(theta_);
    double temp =
        (force + polemass_length * theta_dot_ * theta_dot_ * sinth) /
        total_mass;
    double thetaacc =
        (gravity * sinth - costh * temp) /
        (length * (4.0 / 3.0 - masspole * costh * costh / total_mass));
    double xacc = temp - polemass_length * thetaacc * costh / total_mass;

    x_ += tau * x_dot_;
    x_dot_ += tau * xacc;
    theta_ += tau * theta_dot_;
    theta_dot_ += tau * thetaacc;
    ++t_;

    bool terminal = std::abs(x_) > x_thresh ||
                    std::abs(theta_) > theta_thresh || t_ >= 500;
    *reward = prev_done ? 0.0f : 1.0f;
    *done = terminal ? 1 : 0;
    if (terminal) {
      reset(rng, obs);
    } else {
      write_obs(obs);
    }
  }

  int obs_dim() const override { return 4; }
  int num_actions() const override { return 2; }

 private:
  void write_obs(float* obs) const {
    obs[0] = static_cast<float>(x_);
    obs[1] = static_cast<float>(x_dot_);
    obs[2] = static_cast<float>(theta_);
    obs[3] = static_cast<float>(theta_dot_);
  }
  double x_ = 0, x_dot_ = 0, theta_ = 0, theta_dot_ = 0;
  int t_ = 0;
};

// ----------------------------------------------------------------------
// Acrobot-v1 (RK4 two-link swing-up, mirrors envs/classic/acrobot.py)
// ----------------------------------------------------------------------
class Acrobot : public Env {
 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    std::uniform_real_distribution<double> d(-0.1, 0.1);
    s_[0] = d(rng); s_[1] = d(rng); s_[2] = d(rng); s_[3] = d(rng);
    t_ = 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    double torque = action - 1.0;  // {-1, 0, 1}
    double aug[5] = {s_[0], s_[1], s_[2], s_[3], torque};
    rk4(aug);
    s_[0] = wrap(aug[0]); s_[1] = wrap(aug[1]);
    s_[2] = std::clamp(aug[2], -4 * kPi, 4 * kPi);
    s_[3] = std::clamp(aug[3], -9 * kPi, 9 * kPi);
    ++t_;

    bool solved = -std::cos(s_[0]) - std::cos(s_[1] + s_[0]) > 1.0;
    bool terminal = solved || t_ >= 500;
    *reward = solved ? 0.0f : -1.0f;
    *done = terminal ? 1 : 0;
    if (terminal) {
      reset(rng, obs);
    } else {
      write_obs(obs);
    }
  }

  int obs_dim() const override { return 6; }
  int num_actions() const override { return 3; }

 private:
  static double wrap(double x) {
    double r = std::fmod(x + kPi, 2 * kPi);
    if (r < 0) r += 2 * kPi;
    return r - kPi;
  }

  static void dsdt(const double* s, double* out) {
    const double m = 1.0, l1 = 1.0, lc = 0.5, I = 1.0, g = 9.8;
    double th1 = s[0], th2 = s[1], dth1 = s[2], dth2 = s[3], a = s[4];
    double d1 = m * lc * lc +
                m * (l1 * l1 + lc * lc + 2 * l1 * lc * std::cos(th2)) + 2 * I;
    double d2 = m * (lc * lc + l1 * lc * std::cos(th2)) + I;
    double phi2 = m * lc * g * std::cos(th1 + th2 - kPi / 2);
    double phi1 = -m * l1 * lc * dth2 * dth2 * std::sin(th2) -
                  2 * m * l1 * lc * dth2 * dth1 * std::sin(th2) +
                  (m * lc + m * l1) * g * std::cos(th1 - kPi / 2) + phi2;
    double ddth2 =
        (a + d2 / d1 * phi1 - m * l1 * lc * dth1 * dth1 * std::sin(th2) -
         phi2) /
        (m * lc * lc + I - d2 * d2 / d1);
    double ddth1 = -(d2 * ddth2 + phi1) / d1;
    out[0] = dth1; out[1] = dth2; out[2] = ddth1; out[3] = ddth2; out[4] = 0;
  }

  static void rk4(double* s) {
    const double dt = 0.2;
    double k1[5], k2[5], k3[5], k4[5], tmp[5];
    dsdt(s, k1);
    for (int i = 0; i < 5; ++i) tmp[i] = s[i] + dt / 2 * k1[i];
    dsdt(tmp, k2);
    for (int i = 0; i < 5; ++i) tmp[i] = s[i] + dt / 2 * k2[i];
    dsdt(tmp, k3);
    for (int i = 0; i < 5; ++i) tmp[i] = s[i] + dt * k3[i];
    dsdt(tmp, k4);
    for (int i = 0; i < 5; ++i)
      s[i] += dt / 6.0 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i]);
  }

  void write_obs(float* obs) const {
    obs[0] = static_cast<float>(std::cos(s_[0]));
    obs[1] = static_cast<float>(std::sin(s_[0]));
    obs[2] = static_cast<float>(std::cos(s_[1]));
    obs[3] = static_cast<float>(std::sin(s_[1]));
    obs[4] = static_cast<float>(s_[2]);
    obs[5] = static_cast<float>(s_[3]);
  }

  double s_[4] = {0, 0, 0, 0};
  int t_ = 0;
};

// ----------------------------------------------------------------------
// Breakout-MinAtar (game logic mirrors envs/minatar/breakout.py: 10x10
// grid, channels [paddle, ball, trail, brick], 3 actions, strike latch,
// paddle-corner re-aim, wall respawn). A real *game* in the host pool so
// the C++-envs + CNN training path exercises the same architecture the
// reference uses for Atari (pqn_atari.py).
// ----------------------------------------------------------------------
class MinAtarBreakout : public Env {
 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    int start = static_cast<int>(rng() & 1);
    ball_x_ = start == 0 ? 0 : 9;
    dir_ = start == 0 ? 2 : 3;
    ball_y_ = 3;
    pos_ = 4;
    last_x_ = ball_x_;
    last_y_ = ball_y_;
    strike_ = false;
    t_ = 0;
    for (int y = 0; y < 10; ++y)
      for (int x = 0; x < 10; ++x) brick_[y][x] = (y >= 1 && y <= 3) ? 1 : 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    static const int kDx[4] = {-1, 1, 1, -1};
    static const int kDy[4] = {-1, -1, 1, 1};
    static const int kBounceX[4] = {1, 0, 3, 2};
    static const int kBounceY[4] = {3, 2, 1, 0};
    static const int kBounceCorner[4] = {2, 3, 0, 1};

    if (action == 1) pos_ = std::max(0, pos_ - 1);
    if (action == 2) pos_ = std::min(9, pos_ + 1);

    last_x_ = ball_x_;
    last_y_ = ball_y_;
    int nx = ball_x_ + kDx[dir_];
    int ny = ball_y_ + kDy[dir_];
    float r = 0.0f;
    bool terminal = false;

    if (nx < 0 || nx > 9) {
      nx = std::clamp(nx, 0, 9);
      dir_ = kBounceX[dir_];
    }
    if (ny < 0) {
      ny = 0;
      dir_ = kBounceY[dir_];
    }
    bool hit_brick = ny >= 0 && ny <= 9 && brick_[ny][nx] == 1;
    if (hit_brick) {
      if (!strike_) {
        r += 1.0f;
        strike_ = true;
        brick_[ny][nx] = 0;
        dir_ = kBounceY[dir_];
        ny = last_y_;
      }
    } else if (ny == 9) {
      int total = 0;
      for (auto& row : brick_)
        for (int v : row) total += v;
      if (total == 0)
        for (int y = 1; y <= 3; ++y)
          for (int x = 0; x < 10; ++x) brick_[y][x] = 1;
      if (ball_x_ == pos_) {
        dir_ = kBounceY[dir_];
        ny = last_y_;
      } else if (nx == pos_) {
        dir_ = kBounceCorner[dir_];
        ny = last_y_;
      } else {
        terminal = true;
      }
    }
    if (!hit_brick) strike_ = false;

    ball_x_ = nx;
    ball_y_ = ny;
    ++t_;
    terminal = terminal || t_ >= 1000;

    *reward = r;
    *done = terminal ? 1 : 0;
    if (terminal) {
      reset(rng, obs);
    } else {
      write_obs(obs);
    }
  }

  int obs_dim() const override { return 10 * 10 * 4; }
  int num_actions() const override { return 3; }
  std::vector<int> obs_shape() const override { return {10, 10, 4}; }

 private:
  void write_obs(float* obs) const {
    std::memset(obs, 0, sizeof(float) * 400);
    auto at = [&](int y, int x, int c) -> float& {
      return obs[(y * 10 + x) * 4 + c];
    };
    at(9, pos_, 0) = 1.0f;
    at(ball_y_, ball_x_, 1) = 1.0f;
    at(last_y_, last_x_, 2) = 1.0f;
    for (int y = 0; y < 10; ++y)
      for (int x = 0; x < 10; ++x)
        if (brick_[y][x]) at(y, x, 3) = 1.0f;
  }

  int ball_x_ = 0, ball_y_ = 3, dir_ = 2, pos_ = 4;
  int last_x_ = 0, last_y_ = 3;
  bool strike_ = false;
  int t_ = 0;
  int brick_[10][10] = {};
};


// ----------------------------------------------------------------------
// Asterix-MinAtar (mirrors envs/minatar/asterix.py: 8 entity slots,
// spawn/move cadences with alternating ramp, gold 1/3, 5 actions,
// channels [player, enemy, trail, gold])
// ----------------------------------------------------------------------
class MinAtarAsterix : public Env {
 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    px_ = 5; py_ = 5;
    for (int i = 0; i < 8; ++i) exists_[i] = false;
    spawn_speed_ = 10; spawn_timer_ = 10;
    move_speed_ = 5; move_timer_ = 5;
    ramp_timer_ = 100; ramp_index_ = 0;
    terminal_ = false; t_ = 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    float r = 0.0f;

    // spawn
    bool do_spawn = spawn_timer_ == 0;
    if (do_spawn) {
      int free_slots[8], n_free = 0;
      for (int i = 0; i < 8; ++i)
        if (!exists_[i]) free_slots[n_free++] = i;
      if (n_free > 0) {
        int slot = free_slots[rng() % n_free];
        bool lr = (rng() & 1) != 0;
        bool gold = std::uniform_real_distribution<double>(0, 1)(rng) <
                    (1.0 / 3.0);
        exists_[slot] = true;
        ex_[slot] = lr ? 0 : 9;
        elr_[slot] = lr;
        egold_[slot] = gold;
      }
      spawn_timer_ = spawn_speed_;
    } else {
      --spawn_timer_;
    }

    // player move (x 0..9, y 1..8)
    if (action == 1) px_ = std::max(0, px_ - 1);
    if (action == 3) px_ = std::min(9, px_ + 1);
    if (action == 2) py_ = std::max(1, py_ - 1);
    if (action == 4) py_ = std::min(8, py_ + 1);

    collide(&r);

    // entity move on cadence (off-grid despawn)
    bool do_move = move_timer_ == 0;
    if (do_move) {
      for (int i = 0; i < 8; ++i) {
        if (!exists_[i]) continue;
        ex_[i] += elr_[i] ? 1 : -1;
        if (ex_[i] < 0 || ex_[i] > 9) {
          exists_[i] = false;
          ex_[i] = std::clamp(ex_[i], 0, 9);
        }
      }
      move_timer_ = move_speed_;
    } else {
      --move_timer_;
    }

    collide(&r);

    // alternating spawn/move ramp every 100 steps
    bool can_ramp = spawn_speed_ > 1 || move_speed_ > 1;
    if (can_ramp) {
      if (ramp_timer_ <= 0) {
        if (ramp_index_ % 2 == 1 && move_speed_ > 1) --move_speed_;
        if (ramp_index_ % 2 == 0 && spawn_speed_ > 1) --spawn_speed_;
        ++ramp_index_;
        ramp_timer_ = 100;
      } else {
        --ramp_timer_;
      }
    }

    ++t_;
    bool term = terminal_ || t_ >= 1000;
    *reward = r;
    *done = term ? 1 : 0;
    if (term) reset(rng, obs); else write_obs(obs);
  }

  int obs_dim() const override { return 10 * 10 * 4; }
  int num_actions() const override { return 5; }
  std::vector<int> obs_shape() const override { return {10, 10, 4}; }

 private:
  void collide(float* r) {
    for (int i = 0; i < 8; ++i) {
      int row = i + 1;
      if (exists_[i] && ex_[i] == px_ && row == py_) {
        if (egold_[i]) *r += 1.0f; else terminal_ = true;
        exists_[i] = false;
      }
    }
  }

  void write_obs(float* obs) const {
    std::memset(obs, 0, sizeof(float) * 400);
    auto at = [&](int y, int x, int c) -> float& {
      return obs[(y * 10 + x) * 4 + c];
    };
    at(py_, px_, 0) = 1.0f;
    for (int i = 0; i < 8; ++i) {
      if (!exists_[i]) continue;
      int row = i + 1;
      at(row, ex_[i], egold_[i] ? 3 : 1) = 1.0f;
      int trail = std::clamp(ex_[i] + (elr_[i] ? -1 : 1), 0, 9);
      at(row, trail, 2) = 1.0f;
    }
  }

  int px_ = 5, py_ = 5;
  bool exists_[8] = {}; int ex_[8] = {}; bool elr_[8] = {}, egold_[8] = {};
  int spawn_speed_ = 10, spawn_timer_ = 10;
  int move_speed_ = 5, move_timer_ = 5;
  int ramp_timer_ = 100, ramp_index_ = 0;
  bool terminal_ = false;
  int t_ = 0;
};

// ----------------------------------------------------------------------
// Freeway-MinAtar (mirrors envs/minatar/freeway.py: chicken at column 4,
// 8 lanes with per-lane speed timers, 3-step move cooldown, 2500-step
// episodes, channels [chicken, car, speed-trail by |speed|])
// ----------------------------------------------------------------------
class MinAtarFreeway : public Env {
 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    randomize_cars(rng, /*keep_x=*/false);
    pos_ = 9; move_timer_ = 0; t_ = 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    bool moved = move_timer_ == 0 && action != 0;
    if (moved) {
      pos_ = std::clamp(pos_ + (action == 1 ? -1 : 1), 0, 9);
      move_timer_ = 3;
    } else {
      move_timer_ = std::max(0, move_timer_ - 1);
    }

    bool scored = pos_ == 0;
    *reward = scored ? 1.0f : 0.0f;
    if (scored) {
      randomize_cars(rng, /*keep_x=*/true);
      pos_ = 9;
    }

    bool hit = false;
    for (int i = 0; i < 8; ++i)
      if (car_x_[i] == 4 && i + 1 == pos_) hit = true;
    for (int i = 0; i < 8; ++i) {
      if (car_timer_[i] <= 0) {
        car_x_[i] += car_speed_[i] > 0 ? 1 : -1;
        if (car_x_[i] < 0) car_x_[i] = 9;
        if (car_x_[i] > 9) car_x_[i] = 0;
        car_timer_[i] = std::abs(car_speed_[i]);
      } else {
        --car_timer_[i];
      }
    }
    for (int i = 0; i < 8; ++i)
      if (car_x_[i] == 4 && i + 1 == pos_) hit = true;
    if (hit) pos_ = 9;

    ++t_;
    bool term = t_ >= 2500;
    *done = term ? 1 : 0;
    if (term) reset(rng, obs); else write_obs(obs);
  }

  int obs_dim() const override { return 10 * 10 * 7; }
  int num_actions() const override { return 3; }
  std::vector<int> obs_shape() const override { return {10, 10, 7}; }

 private:
  void randomize_cars(std::mt19937_64& rng, bool keep_x) {
    for (int i = 0; i < 8; ++i) {
      int speed = 1 + static_cast<int>(rng() % 5);
      int dir = (rng() & 1) ? 1 : -1;
      car_timer_[i] = speed;
      car_speed_[i] = speed * dir;
      if (!keep_x) car_x_[i] = static_cast<int>(rng() % 10);
    }
  }

  void write_obs(float* obs) const {
    std::memset(obs, 0, sizeof(float) * 700);
    auto at = [&](int y, int x, int c) -> float& {
      return obs[(y * 10 + x) * 7 + c];
    };
    at(pos_, 4, 0) = 1.0f;
    for (int i = 0; i < 8; ++i) {
      int row = i + 1;
      at(row, car_x_[i], 1) = 1.0f;
      int back = car_x_[i] + (car_speed_[i] > 0 ? -1 : 1);
      if (back < 0) back = 9;
      if (back > 9) back = 0;
      at(row, back, 1 + std::abs(car_speed_[i])) = 1.0f;
    }
  }

  int pos_ = 9, move_timer_ = 0, t_ = 0;
  int car_x_[8] = {}, car_timer_[8] = {}, car_speed_[8] = {};
};

// ----------------------------------------------------------------------
// SpaceInvaders-MinAtar (mirrors envs/minatar/space_invaders.py: marching
// 4x6 alien grid, wall drops, nearest-column return fire, wave respawn
// with ramped march, channels [cannon, alien, alien_left, alien_right,
// friendly_bullet, enemy_bullet])
// ----------------------------------------------------------------------
class MinAtarSpaceInvaders : public Env {
 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    pos_ = 5;
    std::memset(f_bullets_, 0, sizeof(f_bullets_));
    std::memset(e_bullets_, 0, sizeof(e_bullets_));
    std::memset(aliens_, 0, sizeof(aliens_));
    for (int y = 0; y < 4; ++y)
      for (int x = 2; x < 8; ++x) aliens_[y][x] = 1;
    alien_dir_ = -1;
    enemy_move_interval_ = 12;
    alien_move_timer_ = 12;
    alien_shot_timer_ = 10;
    ramp_index_ = 0; shot_timer_ = 0;
    terminal_ = false; t_ = 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    bool fire = action == 3 && shot_timer_ == 0;
    if (action == 1) pos_ = std::max(0, pos_ - 1);
    if (action == 2) pos_ = std::min(9, pos_ + 1);
    if (fire) {
      f_bullets_[9][pos_] = 1;
      shot_timer_ = 5;
    } else {
      shot_timer_ = std::max(0, shot_timer_ - 1);
    }

    // bullets travel (friendly up, enemy down)
    for (int y = 0; y < 9; ++y)
      std::memcpy(f_bullets_[y], f_bullets_[y + 1], sizeof(f_bullets_[y]));
    std::memset(f_bullets_[9], 0, sizeof(f_bullets_[9]));
    for (int y = 9; y > 0; --y)
      std::memcpy(e_bullets_[y], e_bullets_[y - 1], sizeof(e_bullets_[y]));
    std::memset(e_bullets_[0], 0, sizeof(e_bullets_[0]));
    if (e_bullets_[9][pos_]) terminal_ = true;

    // alien march
    bool do_move = alien_move_timer_ == 0;
    if (do_move) {
      bool at_edge = false;
      for (int y = 0; y < 10; ++y) {
        if (alien_dir_ < 0 && aliens_[y][0]) at_edge = true;
        if (alien_dir_ > 0 && aliens_[y][9]) at_edge = true;
      }
      if (at_edge) {
        for (int x = 0; x < 10; ++x)
          if (aliens_[9][x]) terminal_ = true;
        alien_dir_ = -alien_dir_;
        // drop one row (roll down)
        for (int y = 9; y > 0; --y)
          std::memcpy(aliens_[y], aliens_[y - 1], sizeof(aliens_[y]));
        std::memset(aliens_[0], 0, sizeof(aliens_[0]));
      } else {
        // shift horizontally by the PRE-flip direction (matches the JAX
        // twin, which shifts with state.alien_dir)
        if (alien_dir_ < 0) {
          for (int y = 0; y < 10; ++y) {
            int first = aliens_[y][0];
            for (int x = 0; x < 9; ++x) aliens_[y][x] = aliens_[y][x + 1];
            aliens_[y][9] = first;
          }
        } else {
          for (int y = 0; y < 10; ++y) {
            int last = aliens_[y][9];
            for (int x = 9; x > 0; --x) aliens_[y][x] = aliens_[y][x - 1];
            aliens_[y][0] = last;
          }
        }
      }
      int count = 0;
      for (auto& row : aliens_) for (int v : row) count += v;
      alien_move_timer_ = std::min(count, enemy_move_interval_);
    } else {
      --alien_move_timer_;
    }
    if (aliens_[9][pos_]) terminal_ = true;

    // alien return fire from the column nearest the cannon (lowest alien)
    bool do_shoot = alien_shot_timer_ == 0;
    if (do_shoot) {
      int best_col = -1, best_dist = 100;
      for (int x = 0; x < 10; ++x) {
        bool has = false;
        for (int y = 0; y < 10; ++y) has = has || aliens_[y][x];
        if (has && std::abs(x - pos_) < best_dist) {
          best_dist = std::abs(x - pos_);
          best_col = x;
        }
      }
      if (best_col >= 0) {
        int row = 0;
        for (int y = 0; y < 10; ++y)
          if (aliens_[y][best_col]) row = y;
        e_bullets_[row][best_col] = 1;
      }
      alien_shot_timer_ = 10;
    } else {
      --alien_shot_timer_;
    }

    // kills
    float r = 0.0f;
    for (int y = 0; y < 10; ++y)
      for (int x = 0; x < 10; ++x)
        if (aliens_[y][x] && f_bullets_[y][x]) {
          r += 1.0f;
          aliens_[y][x] = 0;
          f_bullets_[y][x] = 0;
        }

    // wave cleared -> respawn + ramp
    int remaining = 0;
    for (auto& row : aliens_) for (int v : row) remaining += v;
    if (remaining == 0) {
      for (int y = 0; y < 4; ++y)
        for (int x = 2; x < 8; ++x) aliens_[y][x] = 1;
      if (enemy_move_interval_ > 6) --enemy_move_interval_;
      ++ramp_index_;
    }

    ++t_;
    bool term = terminal_ || t_ >= 1000;
    *reward = r;
    *done = term ? 1 : 0;
    if (term) reset(rng, obs); else write_obs(obs);
  }

  int obs_dim() const override { return 10 * 10 * 6; }
  int num_actions() const override { return 4; }
  std::vector<int> obs_shape() const override { return {10, 10, 6}; }

 private:
  void write_obs(float* obs) const {
    std::memset(obs, 0, sizeof(float) * 600);
    auto at = [&](int y, int x, int c) -> float& {
      return obs[(y * 10 + x) * 6 + c];
    };
    at(9, pos_, 0) = 1.0f;
    for (int y = 0; y < 10; ++y)
      for (int x = 0; x < 10; ++x) {
        if (aliens_[y][x]) {
          at(y, x, 1) = 1.0f;
          at(y, x, alien_dir_ < 0 ? 2 : 3) = 1.0f;
        }
        if (f_bullets_[y][x]) at(y, x, 4) = 1.0f;
        if (e_bullets_[y][x]) at(y, x, 5) = 1.0f;
      }
  }

  int pos_ = 5;
  int f_bullets_[10][10] = {}, e_bullets_[10][10] = {}, aliens_[10][10] = {};
  int alien_dir_ = -1, enemy_move_interval_ = 12, alien_move_timer_ = 12;
  int alien_shot_timer_ = 10, ramp_index_ = 0, shot_timer_ = 0;
  bool terminal_ = false;
  int t_ = 0;
};

// ----------------------------------------------------------------------
// Seaquest-MinAtar (mirrors envs/minatar/seaquest.py: slot-pool entities,
// oxygen/diver management, surfacing rules, 10 obs channels, 6 actions)
// ----------------------------------------------------------------------
class MinAtarSeaquest : public Env {
  static constexpr int kFish = 8, kSubs = 4, kEB = 4, kFB = 4, kDivers = 4;
  static constexpr int kMaxO2 = 200;

 public:
  void reset(std::mt19937_64& rng, float* obs) override {
    sub_x_ = 5; sub_y_ = 0; sub_or_ = 1;
    oxygen_ = kMaxO2; divers_ = 0; shot_timer_ = 0;
    for (int i = 0; i < kFish; ++i) f_ex_[i] = false;
    for (int i = 0; i < kSubs; ++i) { s_ex_[i] = false; s_shot_[i] = 10; }
    for (int i = 0; i < kFB; ++i) fb_ex_[i] = false;
    for (int i = 0; i < kEB; ++i) eb_ex_[i] = false;
    for (int i = 0; i < kDivers; ++i) d_ex_[i] = false;
    spawn_timer_ = 20; diver_spawn_timer_ = 30; move_interval_ = 5;
    surfaced_ = true; terminal_ = false; t_ = 0;
    write_obs(obs);
  }

  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    float r = 0.0f;

    // player
    if (action == 1) sub_x_ = std::max(0, sub_x_ - 1);
    if (action == 3) sub_x_ = std::min(9, sub_x_ + 1);
    if (action == 2) sub_y_ = std::max(0, sub_y_ - 1);
    if (action == 4) sub_y_ = std::min(8, sub_y_ + 1);
    if (action == 1) sub_or_ = 0;
    if (action == 3) sub_or_ = 1;

    // fire into a free friendly-bullet slot
    bool fire = action == 5 && shot_timer_ == 0;
    int slot = pick_free(rng, fb_ex_, kFB);
    if (fire && slot >= 0) {
      fb_ex_[slot] = true;
      fb_x_[slot] = sub_x_;
      fb_y_[slot] = sub_y_;
      fb_dir_[slot] = sub_or_ == 1 ? 1 : -1;
      shot_timer_ = 5;
    } else {
      shot_timer_ = std::max(0, shot_timer_ - 1);
    }

    // bullets move every step
    for (int i = 0; i < kFB; ++i)
      if (fb_ex_[i]) {
        fb_x_[i] += fb_dir_[i];
        if (fb_x_[i] < 0 || fb_x_[i] > 9) fb_ex_[i] = false;
        fb_x_[i] = std::clamp(fb_x_[i], 0, 9);
      }
    for (int i = 0; i < kEB; ++i)
      if (eb_ex_[i]) {
        eb_x_[i] += eb_dir_[i];
        if (eb_x_[i] < 0 || eb_x_[i] > 9) eb_ex_[i] = false;
        eb_x_[i] = std::clamp(eb_x_[i], 0, 9);
      }

    // enemies/divers move on cadence
    move_lane(f_ex_, f_x_, f_dir_, f_timer_, kFish, move_interval_);
    move_lane(s_ex_, s_x_, s_dir_, s_timer_, kSubs, move_interval_);
    move_lane(d_ex_, d_x_, d_dir_, d_timer_, kDivers, move_interval_ * 2);

    // enemy subs shoot: first eligible sub, into a free enemy-bullet slot
    for (int i = 0; i < kSubs; ++i)
      if (s_ex_[i]) --s_shot_[i];
    int shooter = -1;
    for (int i = 0; i < kSubs; ++i)
      if (s_ex_[i] && s_shot_[i] <= 0) { shooter = i; break; }
    if (shooter >= 0) {
      int eslot = pick_free(rng, eb_ex_, kEB);
      if (eslot >= 0) {
        eb_ex_[eslot] = true;
        eb_x_[eslot] = s_x_[shooter];
        eb_y_[eslot] = s_y_[shooter];
        eb_dir_[eslot] = s_dir_[shooter];
        s_shot_[shooter] = 10;
      }
    }

    // friendly bullets hit enemies (post-move positions)
    for (int b = 0; b < kFB; ++b) {
      if (!fb_ex_[b]) continue;
      for (int i = 0; i < kFish; ++i)
        if (f_ex_[i] && fb_x_[b] == f_x_[i] && fb_y_[b] == f_y_[i]) {
          r += 1.0f; f_ex_[i] = false; fb_ex_[b] = false;
        }
      if (!fb_ex_[b]) continue;
      for (int i = 0; i < kSubs; ++i)
        if (s_ex_[i] && fb_x_[b] == s_x_[i] && fb_y_[b] == s_y_[i]) {
          r += 1.0f; s_ex_[i] = false; fb_ex_[b] = false;
        }
    }

    // spawning
    if (--spawn_timer_ <= 0) {
      int lane = 1 + static_cast<int>(rng() % 8);
      bool lr = (rng() & 1) != 0;
      bool is_sub =
          std::uniform_real_distribution<double>(0, 1)(rng) < (1.0 / 3.0);
      if (is_sub) {
        int ss = pick_free(rng, s_ex_, kSubs);
        if (ss >= 0) {
          s_ex_[ss] = true; s_x_[ss] = lr ? 0 : 9; s_y_[ss] = lane;
          s_dir_[ss] = lr ? 1 : -1;
        }
      } else {
        int fs = pick_free(rng, f_ex_, kFish);
        if (fs >= 0) {
          f_ex_[fs] = true; f_x_[fs] = lr ? 0 : 9; f_y_[fs] = lane;
          f_dir_[fs] = lr ? 1 : -1;
        }
      }
      spawn_timer_ = 20;
    }
    if (--diver_spawn_timer_ <= 0) {
      int lane = 1 + static_cast<int>(rng() % 8);
      bool lr = (rng() & 1) != 0;
      int ds = pick_free(rng, d_ex_, kDivers);
      if (ds >= 0) {
        d_ex_[ds] = true; d_x_[ds] = lr ? 0 : 9; d_y_[ds] = lane;
        d_dir_[ds] = lr ? 1 : -1;
      }
      diver_spawn_timer_ = 30;
    }

    // pick up divers
    for (int i = 0; i < kDivers; ++i)
      if (d_ex_[i] && d_x_[i] == sub_x_ && d_y_[i] == sub_y_) {
        divers_ = std::min(divers_ + 1, 6);
        d_ex_[i] = false;
      }

    // enemy contact
    bool hit_enemy = false;
    for (int i = 0; i < kFish; ++i)
      if (f_ex_[i] && f_x_[i] == sub_x_ && f_y_[i] == sub_y_) hit_enemy = true;
    for (int i = 0; i < kSubs; ++i)
      if (s_ex_[i] && s_x_[i] == sub_x_ && s_y_[i] == sub_y_) hit_enemy = true;
    for (int i = 0; i < kEB; ++i)
      if (eb_ex_[i] && eb_x_[i] == sub_x_ && eb_y_[i] == sub_y_)
        hit_enemy = true;

    // oxygen / surfacing
    bool underwater = sub_y_ > 0;
    if (underwater) --oxygen_;
    bool now_surfacing = !underwater && !surfaced_;
    bool fatal_surface = now_surfacing && divers_ == 0;
    if (now_surfacing && !fatal_surface) {
      if (divers_ == 6) {
        r += static_cast<float>(oxygen_) / 10.0f;
        divers_ = 0;
      } else {
        divers_ -= 1;
      }
      oxygen_ = kMaxO2;
    }
    surfaced_ = !underwater;

    terminal_ = terminal_ || hit_enemy || fatal_surface || oxygen_ < 0;
    ++t_;
    bool term = terminal_ || t_ >= 1000;
    *reward = r;
    *done = term ? 1 : 0;
    if (term) reset(rng, obs); else write_obs(obs);
  }

  int obs_dim() const override { return 10 * 10 * 10; }
  int num_actions() const override { return 6; }
  std::vector<int> obs_shape() const override { return {10, 10, 10}; }

 private:
  static void move_lane(bool* ex, int* x, int* dir, int* timer, int n,
                        int interval) {
    for (int i = 0; i < n; ++i) {
      if (timer[i] <= 0) {
        if (ex[i]) {
          x[i] += dir[i];
          if (x[i] < 0 || x[i] > 9) ex[i] = false;
          x[i] = std::clamp(x[i], 0, 9);
        }
        timer[i] = interval;
      } else {
        --timer[i];
      }
    }
  }

  static int pick_free(std::mt19937_64& rng, const bool* ex, int n) {
    int free_slots[8], n_free = 0;
    for (int i = 0; i < n; ++i)
      if (!ex[i]) free_slots[n_free++] = i;
    if (n_free == 0) return -1;
    return free_slots[rng() % n_free];
  }

  void write_obs(float* obs) const {
    std::memset(obs, 0, sizeof(float) * 1000);
    auto at = [&](int y, int x, int c) -> float& {
      return obs[(y * 10 + x) * 10 + c];
    };
    at(sub_y_, sub_x_, 0) = 1.0f;
    at(sub_y_, std::clamp(sub_x_ + (sub_or_ == 1 ? -1 : 1), 0, 9), 1) = 1.0f;
    for (int i = 0; i < kFB; ++i)
      if (fb_ex_[i]) {
        at(fb_y_[i], fb_x_[i], 2) = 1.0f;
        at(fb_y_[i], std::clamp(fb_x_[i] - fb_dir_[i], 0, 9), 3) = 1.0f;
      }
    for (int i = 0; i < kSubs; ++i)
      if (s_ex_[i]) at(s_y_[i], s_x_[i], 4) = 1.0f;
    for (int i = 0; i < kEB; ++i)
      if (eb_ex_[i]) at(eb_y_[i], eb_x_[i], 5) = 1.0f;
    for (int i = 0; i < kFish; ++i)
      if (f_ex_[i]) at(f_y_[i], f_x_[i], 6) = 1.0f;
    for (int i = 0; i < kDivers; ++i)
      if (d_ex_[i]) at(d_y_[i], d_x_[i], 7) = 1.0f;
    int oxy_cells = std::clamp(oxygen_ * 10 / kMaxO2, 0, 9);
    for (int x = 0; x < 10; ++x) {
      if (x < oxy_cells) at(9, x, 8) = 1.0f;
      if (x < divers_) at(9, x, 9) = 1.0f;
    }
  }

  int sub_x_ = 5, sub_y_ = 0, sub_or_ = 1;
  int oxygen_ = kMaxO2, divers_ = 0, shot_timer_ = 0;
  bool f_ex_[kFish] = {}; int f_x_[kFish] = {}, f_y_[kFish] = {},
      f_dir_[kFish] = {}, f_timer_[kFish] = {};
  bool s_ex_[kSubs] = {}; int s_x_[kSubs] = {}, s_y_[kSubs] = {},
      s_dir_[kSubs] = {}, s_timer_[kSubs] = {}, s_shot_[kSubs] = {};
  bool fb_ex_[kFB] = {}; int fb_x_[kFB] = {}, fb_y_[kFB] = {},
      fb_dir_[kFB] = {};
  bool eb_ex_[kEB] = {}; int eb_x_[kEB] = {}, eb_y_[kEB] = {},
      eb_dir_[kEB] = {};
  bool d_ex_[kDivers] = {}; int d_x_[kDivers] = {}, d_y_[kDivers] = {},
      d_dir_[kDivers] = {}, d_timer_[kDivers] = {};
  int spawn_timer_ = 20, diver_spawn_timer_ = 30, move_interval_ = 5;
  bool surfaced_ = true, terminal_ = false;
  int t_ = 0;
};

// ----------------------------------------------------------------------
// Plug-in registry + adapter
// ----------------------------------------------------------------------
std::mutex g_plugins_mu;
std::unordered_map<std::string, EhPluginVTable>& plugin_registry() {
  static std::unordered_map<std::string, EhPluginVTable> reg;
  return reg;
}

class PluginEnv : public Env {
 public:
  explicit PluginEnv(const EhPluginVTable& vt) : vt_(vt) {}
  ~PluginEnv() override {
    if (inst_) vt_.destroy(inst_);
  }
  void reset(std::mt19937_64& rng, float* obs) override {
    if (!inst_) inst_ = vt_.create(rng());
    vt_.reset(inst_, obs);
  }
  void step(std::mt19937_64& rng, int action, float* obs, float* reward,
            uint8_t* done) override {
    if (!inst_) inst_ = vt_.create(rng());
    vt_.step(inst_, action, obs, reward, done);
  }
  int obs_dim() const override { return vt_.obs_dim; }
  int num_actions() const override { return vt_.num_actions; }
  std::vector<int> obs_shape() const override {
    std::vector<int> s;
    for (int i = 0; i < vt_.obs_rank; ++i) s.push_back(vt_.obs_shape[i]);
    return s;
  }

 private:
  EhPluginVTable vt_;
  void* inst_ = nullptr;
};

std::unique_ptr<Env> make_env(const std::string& name) {
  if (name == "CartPole-v1") return std::make_unique<CartPole>();
  if (name == "Acrobot-v1") return std::make_unique<Acrobot>();
  if (name == "Breakout-MinAtar") return std::make_unique<MinAtarBreakout>();
  if (name == "Asterix-MinAtar") return std::make_unique<MinAtarAsterix>();
  if (name == "Freeway-MinAtar") return std::make_unique<MinAtarFreeway>();
  if (name == "SpaceInvaders-MinAtar")
    return std::make_unique<MinAtarSpaceInvaders>();
  if (name == "Seaquest-MinAtar") return std::make_unique<MinAtarSeaquest>();
  {
    std::lock_guard<std::mutex> lk(g_plugins_mu);
    auto it = plugin_registry().find(name);
    if (it != plugin_registry().end())
      return std::make_unique<PluginEnv>(it->second);
  }
  return nullptr;
}

// ----------------------------------------------------------------------
// Thread pool stepping disjoint env ranges each round
// ----------------------------------------------------------------------
class Pool {
 public:
  Pool(const std::string& name, int num_envs, int num_threads, uint64_t seed)
      : num_envs_(num_envs),
        num_threads_(std::max(1, std::min(num_threads, num_envs))) {
    for (int i = 0; i < num_envs; ++i) {
      envs_.push_back(make_env(name));
      rngs_.emplace_back(seed + 0x9E3779B97F4A7C15ULL * (i + 1));
    }
    obs_dim_ = envs_[0]->obs_dim();
    num_actions_ = envs_[0]->num_actions();
    obs_shape_ = envs_[0]->obs_shape();
    workers_.reserve(num_threads_);
    for (int w = 0; w < num_threads_; ++w) {
      workers_.emplace_back([this, w] { worker_loop(w); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      shutdown_ = true;
      ++generation_;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  bool valid() const { return envs_[0] != nullptr; }
  int obs_dim() const { return obs_dim_; }
  int num_actions() const { return num_actions_; }
  int num_envs() const { return num_envs_; }
  const std::vector<int>& obs_shape() const { return obs_shape_; }

  void reset(float* obs) {
    run_round([this, obs](int i) {
      envs_[i]->reset(rngs_[i], obs + i * obs_dim_);
    });
  }

  void step(const int32_t* actions, float* obs, float* rewards,
            uint8_t* dones) {
    run_round([this, actions, obs, rewards, dones](int i) {
      envs_[i]->step(rngs_[i], actions[i], obs + i * obs_dim_, rewards + i,
                     dones + i);
    });
  }

 private:
  void run_round(std::function<void(int)> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      task_ = std::move(fn);
      pending_ = num_threads_;
      ++generation_;
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  void worker_loop(int w) {
    uint64_t seen = 0;
    const int chunk = (num_envs_ + num_threads_ - 1) / num_threads_;
    const int lo = w * chunk;
    const int hi = std::min(num_envs_, lo + chunk);
    for (;;) {
      std::function<void(int)> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return generation_ != seen; });
        seen = generation_;
        if (shutdown_) return;
        task = task_;
      }
      for (int i = lo; i < hi; ++i) task(i);
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_one();
      }
    }
  }

  int num_envs_;
  int num_threads_;
  int obs_dim_ = 0;
  int num_actions_ = 0;
  std::vector<int> obs_shape_;
  std::vector<std::unique_ptr<Env>> envs_;
  std::vector<std::mt19937_64> rngs_;
  std::vector<std::thread> workers_;

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::function<void(int)> task_;
  uint64_t generation_ = 0;
  int pending_ = 0;
  bool shutdown_ = false;
};

}  // namespace

// ----------------------------------------------------------------------
// C ABI
// ----------------------------------------------------------------------
extern "C" {

void* eh_make(const char* env_name, int num_envs, int num_threads,
              uint64_t seed) {
  // Validate the name before constructing the pool: Pool's constructor
  // queries envs_[0] for its spaces.
  if (!make_env(env_name)) return nullptr;
  auto pool = std::make_unique<Pool>(env_name, num_envs, num_threads, seed);
  return pool.release();
}

void eh_close(void* handle) { delete static_cast<Pool*>(handle); }

int eh_obs_dim(void* handle) { return static_cast<Pool*>(handle)->obs_dim(); }

int eh_num_actions(void* handle) {
  return static_cast<Pool*>(handle)->num_actions();
}

int eh_num_envs(void* handle) {
  return static_cast<Pool*>(handle)->num_envs();
}

int eh_obs_rank(void* handle) {
  return static_cast<int>(static_cast<Pool*>(handle)->obs_shape().size());
}

void eh_obs_shape(void* handle, int32_t* dims) {
  const auto& shape = static_cast<Pool*>(handle)->obs_shape();
  for (size_t i = 0; i < shape.size(); ++i) dims[i] = shape[i];
}

void eh_reset(void* handle, float* obs) {
  static_cast<Pool*>(handle)->reset(obs);
}

void eh_step(void* handle, const int32_t* actions, float* obs, float* rewards,
             uint8_t* dones) {
  static_cast<Pool*>(handle)->step(actions, obs, rewards, dones);
}

// Load an external game plug-in (.so exposing eh_plugin_get) and register
// it under its self-declared name. Returns 0 on success, a negative code
// on failure (-1 dlopen, -2 missing symbol, -3 plugin init, -4 bad vtable).
// The handle is intentionally leaked: game code must outlive every pool.
int eh_load_plugin(const char* so_path) {
  void* h = dlopen(so_path, RTLD_NOW | RTLD_LOCAL);
  if (!h) return -1;
  using GetFn = int (*)(EhPluginVTable*);
  auto get = reinterpret_cast<GetFn>(dlsym(h, "eh_plugin_get"));
  if (!get) return -2;
  EhPluginVTable vt;
  std::memset(&vt, 0, sizeof(vt));
  if (get(&vt) != 0) return -3;
  if (!vt.name || !vt.create || !vt.destroy || !vt.reset || !vt.step ||
      vt.obs_rank < 1 || vt.obs_rank > 3 || vt.obs_dim <= 0 ||
      vt.num_actions <= 0)
    return -4;
  std::lock_guard<std::mutex> lk(g_plugins_mu);
  plugin_registry()[vt.name] = vt;
  return 0;
}

}  // extern "C"
