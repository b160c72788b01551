// Autotuner: Gaussian-process Bayesian optimization over the engine knobs.
//
// Native re-design of the reference's parameter manager + optim stack
// (horovod/common/parameter_manager.{cc,h}: Bayesian tuning of fusion
// threshold and cycle time with categorical hierarchical flags;
// horovod/common/optim/bayesian_optimization.{cc,h}: expected-improvement
// acquisition; horovod/common/optim/gaussian_process.{cc,h}: GPML Alg 2.1
// fit/predict with a squared-exponential kernel). Differences:
// - no Eigen/LBFGS++ dependency: the GP uses an in-house Cholesky solve
//   (dimensions are tiny — dozens of samples, 2 knobs), and the acquisition
//   is maximized by quasi-random candidate search instead of L-BFGS;
// - scoring is throughput in bytes/us of collective traffic, like the
//   reference (parameter_manager.cc: scores are total bytes / total seconds).
#ifndef HVD_AUTOTUNER_H
#define HVD_AUTOTUNER_H

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <random>
#include <string>
#include <vector>

namespace hvd {

// ------------------------------------------------------------ linear algebra

// Cholesky decomposition of a (small) SPD matrix, row-major. Returns false if
// not positive definite.
inline bool cholesky(std::vector<double>& a, int n) {
  for (int i = 0; i < n; i++) {
    for (int j = 0; j <= i; j++) {
      double sum = a[(size_t)i * n + j];
      for (int k = 0; k < j; k++) sum -= a[(size_t)i * n + k] * a[(size_t)j * n + k];
      if (i == j) {
        if (sum <= 0.0) return false;
        a[(size_t)i * n + j] = std::sqrt(sum);
      } else {
        a[(size_t)i * n + j] = sum / a[(size_t)j * n + j];
      }
    }
    for (int j = i + 1; j < n; j++) a[(size_t)i * n + j] = 0.0;
  }
  return true;
}

// Solve L y = b (forward) then L^T x = y (backward); L lower-triangular.
inline std::vector<double> chol_solve(const std::vector<double>& L, int n,
                                      std::vector<double> b) {
  for (int i = 0; i < n; i++) {
    double sum = b[(size_t)i];
    for (int k = 0; k < i; k++) sum -= L[(size_t)i * n + k] * b[(size_t)k];
    b[(size_t)i] = sum / L[(size_t)i * n + i];
  }
  for (int i = n - 1; i >= 0; i--) {
    double sum = b[(size_t)i];
    for (int k = i + 1; k < n; k++) sum -= L[(size_t)k * n + i] * b[(size_t)k];
    b[(size_t)i] = sum / L[(size_t)i * n + i];
  }
  return b;
}

inline std::vector<double> forward_solve(const std::vector<double>& L, int n,
                                         const std::vector<double>& b) {
  std::vector<double> y(b);
  for (int i = 0; i < n; i++) {
    double sum = y[(size_t)i];
    for (int k = 0; k < i; k++) sum -= L[(size_t)i * n + k] * y[(size_t)k];
    y[(size_t)i] = sum / L[(size_t)i * n + i];
  }
  return y;
}

// ------------------------------------------------------------------------ GP

// Squared-exponential-kernel GP regressor (reference gaussian_process.h:46-92,
// GPML Algorithm 2.1).
class GaussianProcess {
 public:
  explicit GaussianProcess(double length_scale = 0.3, double signal_var = 1.0,
                           double noise_var = 1e-4)
      : l2_(length_scale * length_scale), sf2_(signal_var), sn2_(noise_var) {}

  bool fit(const std::vector<std::vector<double>>& X,
           const std::vector<double>& y) {
    X_ = X;
    int n = (int)X.size();
    if (n == 0) return false;
    // normalize targets
    double mean = 0;
    for (double v : y) mean += v;
    mean /= n;
    double var = 0;
    for (double v : y) var += (v - mean) * (v - mean);
    var = n > 1 ? var / (n - 1) : 1.0;
    y_mean_ = mean;
    y_std_ = var > 1e-12 ? std::sqrt(var) : 1.0;
    std::vector<double> yn(y.size());
    for (size_t i = 0; i < y.size(); i++) yn[i] = (y[i] - y_mean_) / y_std_;

    L_.assign((size_t)n * n, 0.0);
    for (int i = 0; i < n; i++) {
      for (int j = 0; j < n; j++) {
        L_[(size_t)i * n + j] = kernel(X[(size_t)i], X[(size_t)j]);
        if (i == j) L_[(size_t)i * n + j] += sn2_;
      }
    }
    if (!cholesky(L_, n)) return false;
    alpha_ = chol_solve(L_, n, yn);
    n_ = n;
    return true;
  }

  void predict(const std::vector<double>& x, double* mu, double* sigma) const {
    if (n_ == 0) {
      *mu = 0;
      *sigma = 1;
      return;
    }
    std::vector<double> ks((size_t)n_);
    for (int i = 0; i < n_; i++) ks[(size_t)i] = kernel(x, X_[(size_t)i]);
    double m = 0;
    for (int i = 0; i < n_; i++) m += ks[(size_t)i] * alpha_[(size_t)i];
    auto v = forward_solve(L_, n_, ks);
    double var = sf2_;
    for (int i = 0; i < n_; i++) var -= v[(size_t)i] * v[(size_t)i];
    *mu = m * y_std_ + y_mean_;
    *sigma = std::sqrt(std::max(var, 1e-12)) * y_std_;
  }

 private:
  double kernel(const std::vector<double>& a, const std::vector<double>& b) const {
    double d2 = 0;
    for (size_t i = 0; i < a.size(); i++) d2 += (a[i] - b[i]) * (a[i] - b[i]);
    return sf2_ * std::exp(-0.5 * d2 / l2_);
  }

  double l2_, sf2_, sn2_;
  std::vector<std::vector<double>> X_;
  std::vector<double> L_, alpha_;
  double y_mean_ = 0, y_std_ = 1;
  int n_ = 0;
};

// ------------------------------------------------------------------------ BO

// Expected-improvement Bayesian optimizer over the unit hypercube
// (reference bayesian_optimization.h:45-110).
class BayesianOptimizer {
 public:
  explicit BayesianOptimizer(int dims, double xi = 0.01, uint64_t seed = 1234)
      : dims_(dims), xi_(xi), rng_(seed), fixed_((size_t)dims, false),
        fixed_val_((size_t)dims, 0.0) {}

  // Pin a coordinate: candidates always carry `v` there. Without this, a
  // dead dimension (pinned knob, non-capable categorical) inflates EI far
  // from the recorded samples along that axis and the search burns rounds
  // re-measuring configs that collapse to already-tested real ones.
  void fix_dim(int d, double v) {
    fixed_[(size_t)d] = true;
    fixed_val_[(size_t)d] = v;
  }
  void unfix_dim(int d) { fixed_[(size_t)d] = false; }

  void add_sample(const std::vector<double>& x, double y) {
    X_.push_back(x);
    y_.push_back(y);
  }

  std::vector<double> next_sample() {
    if (X_.empty()) return random_point();
    GaussianProcess gp;
    if (!gp.fit(X_, y_)) return random_point();
    double best_y = *std::max_element(y_.begin(), y_.end());
    std::vector<double> best_x = random_point();
    double best_ei = -1;
    for (int c = 0; c < 256; c++) {
      auto x = random_point();
      double mu, sigma;
      gp.predict(x, &mu, &sigma);
      double ei;
      if (sigma < 1e-12) {
        ei = 0;
      } else {
        double z = (mu - best_y - xi_) / sigma;
        ei = (mu - best_y - xi_) * phi_cdf(z) + sigma * phi_pdf(z);
      }
      if (ei > best_ei) {
        best_ei = ei;
        best_x = x;
      }
    }
    return best_x;
  }

  const std::vector<std::vector<double>>& samples() const { return X_; }
  const std::vector<double>& scores() const { return y_; }

 private:
  static double phi_pdf(double z) {
    return std::exp(-0.5 * z * z) / std::sqrt(2 * M_PI);
  }
  static double phi_cdf(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }

  std::vector<double> random_point() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    std::vector<double> x((size_t)dims_);
    for (size_t i = 0; i < x.size(); i++)
      x[i] = fixed_[i] ? fixed_val_[i] : u(rng_);
    return x;
  }

  int dims_;
  double xi_;
  std::mt19937_64 rng_;
  std::vector<bool> fixed_;
  std::vector<double> fixed_val_;
  std::vector<std::vector<double>> X_;
  std::vector<double> y_;
};

// ------------------------------------------------------------ ParameterManager

// Tunes (fusion_threshold, cycle_time_ms) by measured collective throughput
// (reference parameter_manager.cc:145-233: warmup discard, samples of many
// cycles, median score in bytes/us, rank-0 tunes and broadcasts). In
// multi-process worlds exactly one instance runs, inside the rank-0
// coordinator, and the tuned knobs ride the per-tick ResponseList broadcast
// so every rank applies the same values on the same tick — the socket
// analog of the reference's MPI_Bcast in SyncParams
// (parameter_manager.cc:213-233). Single-process engines tune locally.
class ParameterManager {
 public:
  struct Knobs {
    int64_t fusion_threshold;
    double cycle_time_ms;
    // Categorical dimensions (reference parameter_manager.h:172 tunes
    // hierarchical_allreduce / hierarchical_allgather as categorical
    // parameters alongside the numeric chain).
    bool hier_allreduce = false;
    bool hier_allgather = false;
    // Gradient bucket count for the overlap scheduler (HOROVOD_NUM_BUCKETS):
    // tuned JOINTLY with the fusion threshold — more buckets buy overlap but
    // pay per-collective launch overhead, and the trade moves with the
    // threshold, so the two live in one acquisition space.
    int num_buckets = 1;
  };

  ParameterManager(int64_t init_threshold, double init_cycle_ms,
                   bool threshold_pinned, bool cycle_pinned)
      : bo_(5),
        current_{init_threshold, init_cycle_ms, false, false, 1},
        best_{init_threshold, init_cycle_ms, false, false, 1},
        threshold_pinned_(threshold_pinned),
        cycle_pinned_(cycle_pinned) {
    active_ = !(threshold_pinned_ && cycle_pinned_);
    // Dead dimensions stay clamped to the live config's coordinates so the
    // acquisition never wastes rounds exploring axes from_unit ignores.
    auto u = to_unit(current_);
    if (threshold_pinned_) bo_.fix_dim(0, u[0]);
    if (cycle_pinned_) bo_.fix_dim(1, u[1]);
    bo_.fix_dim(2, u[2]);  // categorical dims open via enable_hierarchy_tuning
    bo_.fix_dim(3, u[3]);
    bo_.fix_dim(4, u[4]);  // bucket dim opens via set_num_buckets(pinned=false)
  }

  bool active() const { return active_; }
  Knobs knobs() const { return current_; }
  Knobs best() const { return best_; }

  void set_log_path(const std::string& p) { log_path_ = p; }

  // Seed the categorical knobs from config (env) and record pins. Called
  // before any tick updates.
  void set_hierarchy(bool allreduce_on, bool allgather_on,
                     bool allreduce_pinned, bool allgather_pinned) {
    current_.hier_allreduce = best_.hier_allreduce = allreduce_on;
    current_.hier_allgather = best_.hier_allgather = allgather_on;
    hier_ar_pinned_ = allreduce_pinned;
    hier_ag_pinned_ = allgather_pinned;
    bo_.fix_dim(2, allreduce_on ? 1.0 : 0.0);
    bo_.fix_dim(3, allgather_on ? 1.0 : 0.0);
  }

  // Seed the bucket-count knob and open (or pin) its search dimension. The
  // JAX-side tuner calls this with pinned=false to tune
  // (fusion_threshold, num_buckets) jointly; callers that only replay a
  // known-good config pass pinned=true.
  void set_num_buckets(int v, bool pinned) {
    if (v < 1) v = 1;
    if (v > (int)kMaxBuckets) v = (int)kMaxBuckets;
    current_.num_buckets = best_.num_buckets = v;
    tune_buckets_ = !pinned;
    if (pinned) {
      bo_.fix_dim(4, to_unit(current_)[4]);
    } else {
      bo_.unfix_dim(4);
      active_ = true;
    }
  }

  // Open the categorical dimensions for exploration. Only meaningful on a
  // genuinely multi-level topology — the coordinator calls this once after
  // registration, when it has every rank's local/cross coordinates and has
  // validated that the two-level rings exist (engine.cc analyze_hier).
  void enable_hierarchy_tuning(bool allreduce_capable, bool allgather_capable) {
    tune_hier_ar_ = allreduce_capable && !hier_ar_pinned_;
    tune_hier_ag_ = allgather_capable && !hier_ag_pinned_;
    if (tune_hier_ar_) bo_.unfix_dim(2);
    if (tune_hier_ag_) bo_.unfix_dim(3);
    if (tune_hier_ar_ || tune_hier_ag_) active_ = true;
  }
  bool tunes_hierarchy() const { return tune_hier_ar_ || tune_hier_ag_; }

  // Record one engine sample: bytes moved in `seconds`. Returns true when the
  // knobs changed (caller re-reads knobs()).
  bool update(int64_t bytes, double seconds) {
    if (!active_) return false;
    total_bytes_ += bytes;
    total_seconds_ += seconds;
    if (++updates_ < kCyclesPerSample) return false;
    double score = total_seconds_ > 0
                       ? (double)total_bytes_ / (total_seconds_ * 1e6)
                       : 0.0;  // bytes/us
    updates_ = 0;
    total_bytes_ = 0;
    total_seconds_ = 0;
    if (warmups_left_ > 0) {
      warmups_left_--;
      return false;
    }
    scores_.push_back(score);
    if ((int)scores_.size() < kSamplesPerConfig) return false;
    std::nth_element(scores_.begin(), scores_.begin() + scores_.size() / 2,
                     scores_.end());
    double median = scores_[scores_.size() / 2];
    scores_.clear();
    maybe_log(median);
    if (median > best_score_) {
      best_score_ = median;
      best_ = current_;
    }
    bo_.add_sample(to_unit(current_), median);
    rounds_++;
    if (rounds_ >= kMaxRounds) {
      current_ = best_;
      active_ = false;
      return true;
    }
    current_ = from_unit(bo_.next_sample());
    return true;
  }

 private:
  static constexpr int kCyclesPerSample = 10;   // reference: cycles per sample
  static constexpr int kSamplesPerConfig = 5;   // reference: median of samples
  static constexpr int kMaxRounds = 30;
  static constexpr double kMinThresholdMB = 1.0, kMaxThresholdMB = 256.0;
  static constexpr double kMinCycleMs = 1.0, kMaxCycleMs = 50.0;
  static constexpr double kMaxBuckets = 64.0;   // log2 span of the bucket dim

  std::vector<double> to_unit(const Knobs& k) const {
    double t = std::log2((double)k.fusion_threshold / (1 << 20));
    double lo = std::log2(kMinThresholdMB), hi = std::log2(kMaxThresholdMB);
    return {(t - lo) / (hi - lo),
            (k.cycle_time_ms - kMinCycleMs) / (kMaxCycleMs - kMinCycleMs),
            k.hier_allreduce ? 1.0 : 0.0, k.hier_allgather ? 1.0 : 0.0,
            std::log2((double)std::max(1, k.num_buckets)) /
                std::log2(kMaxBuckets)};
  }

  Knobs from_unit(const std::vector<double>& x) const {
    Knobs k = current_;
    if (!threshold_pinned_) {
      double lo = std::log2(kMinThresholdMB), hi = std::log2(kMaxThresholdMB);
      double mb = std::pow(2.0, lo + x[0] * (hi - lo));
      k.fusion_threshold = (int64_t)(mb * (1 << 20));
    }
    if (!cycle_pinned_) {
      k.cycle_time_ms = kMinCycleMs + x[1] * (kMaxCycleMs - kMinCycleMs);
    }
    // Threshold the continuous BO coordinate into the categorical branch
    // (candidate search covers [0,1], so both branches get explored).
    if (tune_hier_ar_) k.hier_allreduce = x[2] >= 0.5;
    if (tune_hier_ag_) k.hier_allgather = x[3] >= 0.5;
    if (tune_buckets_) {
      // Log-spaced like the threshold: the interesting range is 1..8, not
      // 33..64, and a linear map would spend most of the axis there.
      k.num_buckets =
          (int)std::lround(std::pow(2.0, x[4] * std::log2(kMaxBuckets)));
      if (k.num_buckets < 1) k.num_buckets = 1;
      if (k.num_buckets > (int)kMaxBuckets) k.num_buckets = (int)kMaxBuckets;
    }
    return k;
  }

  void maybe_log(double score) {
    if (log_path_.empty()) return;
    std::FILE* f = std::fopen(log_path_.c_str(), "a");
    if (!f) return;
    // CSV like the reference autotuner log (parameter_manager.cc:93-99)
    std::fprintf(f, "%lld,%.3f,%d,%d,%d,%.6f\n",
                 (long long)current_.fusion_threshold, current_.cycle_time_ms,
                 current_.hier_allreduce ? 1 : 0, current_.hier_allgather ? 1 : 0,
                 current_.num_buckets, score);
    std::fclose(f);
  }

  BayesianOptimizer bo_;
  Knobs current_, best_;
  bool threshold_pinned_, cycle_pinned_;
  bool hier_ar_pinned_ = false, hier_ag_pinned_ = false;
  bool tune_hier_ar_ = false, tune_hier_ag_ = false;
  bool tune_buckets_ = false;
  bool active_ = true;
  int updates_ = 0;
  int warmups_left_ = 3;  // reference: 3 warmup samples discarded
  int rounds_ = 0;
  int64_t total_bytes_ = 0;
  double total_seconds_ = 0;
  double best_score_ = -1;
  std::vector<double> scores_;
  std::string log_path_;
};

}  // namespace hvd

#endif  // HVD_AUTOTUNER_H
