// CVRP local search engine (host-side native tier of deepaco_tpu).
//
// A from-scratch implementation of the classical route-improvement moves the
// reference obtains from its vendored HGS-CVRP library (reference
// cvrp_nls/HGS-CVRP-main/Program/LocalSearch.cpp — relocate/swap/2-opt/2-opt*
// "RI" moves plus Vidal's SWAP* neighborhood): this file shares no code with
// it; the algorithms follow the published description (Vidal 2022, "Hybrid
// genetic search for the CVRP").
//
// Search structure (matching the reference's complexity, not its code):
//  * RI moves run as node-centric sweeps over granular (k-nearest) neighbor
//    lists, applying improvements in place and continuing the sweep — not
//    restarting from scratch after every move.
//  * Per-node freshness clocks skip nodes whose route and neighbor routes
//    are unchanged since the node was last tested (the reference's
//    whenLastTestedRI/whenLastModified scheme, LocalSearch.cpp:30-60).
//  * SWAP* enumerates only route pairs whose polar sectors around the depot
//    overlap (the reference's CircleSector pruning, CircleSector.h +
//    LocalSearch.cpp:485-627) and skips pairs unchanged since their last
//    scan; candidate insertions use a 3-best memo per (customer, route).
//  * A reusable context (cvrp_ls_context_new) holds the instance data and
//    k-NN lists so repeated calls per ant/iteration don't rebuild them.
//
// All moves are capacity-feasible: the engine never leaves feasibility, so
// every returned solution passes the validators (cvrp_nls/test.py:20-37).
// Routes are exchanged with Python IN MEMORY via the extern "C" API below —
// no /tmp files (the reference's file handshake, cvrp_nls/swapstar.py:240-269,
// is a documented fragility; SURVEY §5).
//
// Build: g++ -O3 -march=native -shared -fPIC cvrp_ls.cpp -o libcvrpls.so

#include <algorithm>
#include <array>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr double kTwoPi = 6.283185307179586;

struct Problem {
  int n;                    // nodes incl. depot 0
  const double* D;          // [n*n] distance matrix
  const double* dem;        // [n] demands (dem[0] == 0)
  const double* coords;     // [n*2] or nullptr (enables sector pruning)
  double cap;
  int k_granular;
  std::vector<std::vector<int>> nbr;  // k nearest customers per customer
  std::vector<double> angle;          // polar angle around depot (if coords)

  double d(int i, int j) const { return D[(size_t)i * n + j]; }

  void build_neighbors() {
    nbr.assign(n, {});
    std::vector<std::pair<double, int>> cand;
    cand.reserve(n);
    for (int i = 1; i < n; ++i) {
      cand.clear();
      for (int j = 1; j < n; ++j)
        if (j != i) cand.push_back({d(i, j), j});
      int k = std::min<int>(k_granular, (int)cand.size());
      std::partial_sort(cand.begin(), cand.begin() + k, cand.end());
      nbr[i].reserve(k);
      for (int t = 0; t < k; ++t) nbr[i].push_back(cand[t].second);
    }
    angle.clear();
    if (coords) {
      angle.resize(n, 0.0);
      for (int i = 1; i < n; ++i) {
        double a = std::atan2(coords[2 * i + 1] - coords[1],
                              coords[2 * i] - coords[0]);
        angle[i] = a < 0 ? a + kTwoPi : a;
      }
    }
  }
};

struct Solution {
  std::vector<std::vector<int>> routes;  // customers only (no depot)
  std::vector<double> load;
  std::vector<int> route_of;             // node -> route index
  std::vector<int> pos_of;               // node -> position in route
  std::vector<uint32_t> version;         // bump on route change (memo keys)

  void index_route(int r) {
    for (int p = 0; p < (int)routes[r].size(); ++p) {
      route_of[routes[r][p]] = r;
      pos_of[routes[r][p]] = p;
    }
  }

  void rebuild(const Problem& P) {
    route_of.assign(P.n, -1);
    pos_of.assign(P.n, -1);
    load.assign(routes.size(), 0.0);
    version.assign(routes.size(), 1);
    for (int r = 0; r < (int)routes.size(); ++r) {
      for (int c : routes[r]) load[r] += P.dem[c];
      index_route(r);
    }
  }

  void touch(int r) { ++version[r]; }
};

// cost of route arc sequence 0 -> c1 -> ... -> ck -> 0
double route_cost(const Problem& P, const std::vector<int>& r) {
  if (r.empty()) return 0.0;
  double c = P.d(0, r.front()) + P.d(r.back(), 0);
  for (size_t i = 0; i + 1 < r.size(); ++i) c += P.d(r[i], r[i + 1]);
  return c;
}

inline int pred_node(const std::vector<int>& r, int pos) {
  return pos == 0 ? 0 : r[pos - 1];
}
inline int succ_node(const std::vector<int>& r, int pos) {
  return pos + 1 == (int)r.size() ? 0 : r[pos + 1];
}

// gain of removing customer at pos from route (negative delta = improvement)
inline double removal_delta(const Problem& P, const std::vector<int>& r,
                            int pos) {
  int u = r[pos], p = pred_node(r, pos), s = succ_node(r, pos);
  return P.d(p, s) - P.d(p, u) - P.d(u, s);
}

// delta of inserting u between positions (pos-1, pos) of route r
inline double insertion_delta(const Problem& P, const std::vector<int>& r,
                              int pos, int u) {
  int p = pos == 0 ? 0 : r[pos - 1];
  int s = pos == (int)r.size() ? 0 : r[pos];
  return P.d(p, u) + P.d(u, s) - P.d(p, s);
}

// Minimal circular arc around the depot containing a route's customers:
// sort angles, take the complement of the largest angular gap (the polar
// CircleSector idea from the reference, recomputed per route version).
struct Sector {
  double start = 0.0, width = kTwoPi;
  bool whole = true;  // no coords or empty route: treat as always-overlap
};

Sector route_sector(const Problem& P, const std::vector<int>& route) {
  Sector s;
  if (P.angle.empty() || route.empty()) return s;
  static thread_local std::vector<double> ang;
  ang.clear();
  for (int c : route) ang.push_back(P.angle[c]);
  std::sort(ang.begin(), ang.end());
  int m = (int)ang.size();
  double best_gap = ang.front() + kTwoPi - ang.back();
  int best_at = m - 1;  // gap between last and first (wrapped)
  for (int i = 0; i + 1 < m; ++i) {
    double g = ang[i + 1] - ang[i];
    if (g > best_gap) { best_gap = g; best_at = i; }
  }
  s.whole = false;
  s.start = ang[(best_at + 1) % m];
  s.width = kTwoPi - best_gap;
  return s;
}

inline bool sectors_overlap(const Sector& a, const Sector& b) {
  if (a.whole || b.whole) return true;
  double d1 = std::fmod(b.start - a.start + kTwoPi, kTwoPi);
  if (d1 <= a.width + 1e-12) return true;
  double d2 = std::fmod(a.start - b.start + kTwoPi, kTwoPi);
  return d2 <= b.width + 1e-12;
}

// 3-best insertion positions of a customer into a route, memoized on the
// route version (Vidal's preprocessed insertion costs for SWAP*).
struct ThreeBest {
  uint32_t version = 0;
  double delta[3] = {1e30, 1e30, 1e30};
  int pos[3] = {-1, -1, -1};
};

// ---------------------------------------------------------------------------
// The improvement engine: RI sweeps + sector-pruned SWAP*.
// ---------------------------------------------------------------------------
struct Engine {
  const Problem& P;
  Solution& S;
  int nr;  // route count (fixed; routes may only become empty)

  // freshness clocks (the reference's whenLastModified/whenLastTested idea)
  uint64_t clock = 1;
  std::vector<uint64_t> route_changed;   // [nr] clock of last modification
  std::vector<uint64_t> node_tested;     // [n] clock when u was last tested
  std::vector<uint64_t> pair_tested;     // [nr*nr] clock of last SWAP* scan

  std::vector<ThreeBest> memo;           // [n * nr] insertion memo
  std::vector<Sector> sector;            // [nr], cached per version
  std::vector<uint32_t> sector_version;

  int moves = 0;
  int count_limit;
  std::chrono::steady_clock::time_point deadline;
  bool use_deadline;

  Engine(const Problem& p, Solution& s, int count, double time_limit_s)
      : P(p), S(s), nr((int)s.routes.size()), count_limit(count) {
    route_changed.assign(nr, 0);
    node_tested.assign(P.n, 0);
    pair_tested.assign((size_t)nr * nr, 0);
    memo.assign((size_t)P.n * nr, ThreeBest{});
    sector.assign(nr, Sector{});
    sector_version.assign(nr, 0);
    use_deadline = time_limit_s > 0;
    if (use_deadline)
      deadline = std::chrono::steady_clock::now() +
                 std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                     std::chrono::duration<double>(time_limit_s));
  }

  bool out_of_budget() const {
    if (moves >= count_limit) return true;
    return use_deadline && std::chrono::steady_clock::now() > deadline;
  }

  void mark(int r) {
    S.touch(r);
    route_changed[r] = ++clock;
  }

  const Sector& get_sector(int r) {
    if (sector_version[r] != S.version[r]) {
      sector[r] = route_sector(P, S.routes[r]);
      sector_version[r] = S.version[r];
    }
    return sector[r];
  }

  ThreeBest& best3(int u, int r) {
    ThreeBest& tb = memo[(size_t)u * nr + r];
    if (tb.version != S.version[r]) {
      tb = ThreeBest{};
      tb.version = S.version[r];
      const std::vector<int>& R = S.routes[r];
      for (int pos = 0; pos <= (int)R.size(); ++pos) {
        double dlt = insertion_delta(P, R, pos, u);
        if (dlt < tb.delta[2]) {
          tb.delta[2] = dlt; tb.pos[2] = pos;
          if (tb.delta[2] < tb.delta[1]) {
            std::swap(tb.delta[1], tb.delta[2]);
            std::swap(tb.pos[1], tb.pos[2]);
          }
          if (tb.delta[1] < tb.delta[0]) {
            std::swap(tb.delta[0], tb.delta[1]);
            std::swap(tb.pos[0], tb.pos[1]);
          }
        }
      }
    }
    return tb;
  }

  // ---- RI moves for one node u against granular neighbor v ----------------

  bool try_relocate(int u, int v) {
    int ru = S.route_of[u], pu = S.pos_of[u];
    int rv = S.route_of[v], pv = S.pos_of[v];
    if (rv == ru && (pv == pu - 1 || pv == pu)) return false;
    if (rv != ru && S.load[rv] + P.dem[u] > P.cap) return false;
    double rem = removal_delta(P, S.routes[ru], pu);
    std::vector<int>& RV = S.routes[rv];
    double ins;
    if (rv == ru) {
      int s = succ_node(RV, pv);
      ins = P.d(v, u) + P.d(u, s) - P.d(v, s);
    } else {
      ins = insertion_delta(P, RV, pv + 1, u);
    }
    if (rem + ins >= -1e-9) return false;
    std::vector<int>& RU = S.routes[ru];
    RU.erase(RU.begin() + pu);
    int target = pv + 1;
    if (rv == ru && pu < target) --target;
    RV.insert(RV.begin() + target, u);
    if (rv != ru) {
      S.load[ru] -= P.dem[u];
      S.load[rv] += P.dem[u];
    }
    S.index_route(ru);
    if (rv != ru) S.index_route(rv);
    mark(ru); if (rv != ru) mark(rv);
    return true;
  }

  bool try_swap(int u, int v) {
    int ru = S.route_of[u], pu = S.pos_of[u];
    int rv = S.route_of[v], pv = S.pos_of[v];
    if (u == v) return false;
    if (ru == rv && std::abs(pu - pv) == 1) {
      std::vector<int>& R = S.routes[ru];
      int a = std::min(pu, pv), b = a + 1;
      int p = pred_node(R, a), s = succ_node(R, b);
      double delta =
          P.d(p, R[b]) + P.d(R[a], s) - P.d(p, R[a]) - P.d(R[b], s);
      if (delta >= -1e-9) return false;
      std::swap(R[a], R[b]);
      S.index_route(ru); mark(ru);
      return true;
    }
    if (ru != rv) {
      if (S.load[ru] - P.dem[u] + P.dem[v] > P.cap) return false;
      if (S.load[rv] - P.dem[v] + P.dem[u] > P.cap) return false;
    }
    std::vector<int>& RU = S.routes[ru];
    std::vector<int>& RV = S.routes[rv];
    int pu_p = pred_node(RU, pu), pu_s = succ_node(RU, pu);
    int pv_p = pred_node(RV, pv), pv_s = succ_node(RV, pv);
    double delta = P.d(pu_p, v) + P.d(v, pu_s) + P.d(pv_p, u) + P.d(u, pv_s) -
                   P.d(pu_p, u) - P.d(u, pu_s) - P.d(pv_p, v) - P.d(v, pv_s);
    if (delta >= -1e-9) return false;
    RU[pu] = v; RV[pv] = u;
    if (ru != rv) {
      S.load[ru] += P.dem[v] - P.dem[u];
      S.load[rv] += P.dem[u] - P.dem[v];
    }
    S.route_of[u] = rv; S.pos_of[u] = pv;
    S.route_of[v] = ru; S.pos_of[v] = pu;
    mark(ru); if (ru != rv) mark(rv);
    return true;
  }

  // intra-route 2-opt between arcs (u, succ u) and (v, succ v)
  bool try_two_opt_intra(int u, int v) {
    int ru = S.route_of[u], rv = S.route_of[v];
    if (ru != rv) return false;
    int i = S.pos_of[u], j = S.pos_of[v];
    if (i > j) std::swap(i, j);
    if (j - i < 1) return false;
    std::vector<int>& R = S.routes[ru];
    int a = R[i], b = R[j];
    int sa = succ_node(R, i), sb = succ_node(R, j);
    if (sa == b) return false;  // adjacent arcs: no-op reversal
    double delta = P.d(a, b) + P.d(sa, sb) - P.d(a, sa) - P.d(b, sb);
    if (delta >= -1e-9) return false;
    std::reverse(R.begin() + i + 1, R.begin() + j + 1);
    S.index_route(ru); mark(ru);
    return true;
  }

  // 2-opt*: exchange tails after u (route ru) and after v (route rv)
  bool try_two_opt_star(int u, int v) {
    int ru = S.route_of[u], rv = S.route_of[v];
    if (ru == rv) return false;
    int pu = S.pos_of[u], pv = S.pos_of[v];
    std::vector<int>& RU = S.routes[ru];
    std::vector<int>& RV = S.routes[rv];
    double head_u = 0, head_v = 0;
    for (int t = 0; t <= pu; ++t) head_u += P.dem[RU[t]];
    for (int t = 0; t <= pv; ++t) head_v += P.dem[RV[t]];
    double tail_u = S.load[ru] - head_u, tail_v = S.load[rv] - head_v;
    if (head_u + tail_v > P.cap || head_v + tail_u > P.cap) return false;
    int su = succ_node(RU, pu), sv = succ_node(RV, pv);
    double delta = P.d(u, sv) + P.d(v, su) - P.d(u, su) - P.d(v, sv);
    if (delta >= -1e-9) return false;
    std::vector<int> new_u(RU.begin(), RU.begin() + pu + 1);
    new_u.insert(new_u.end(), RV.begin() + pv + 1, RV.end());
    std::vector<int> new_v(RV.begin(), RV.begin() + pv + 1);
    new_v.insert(new_v.end(), RU.begin() + pu + 1, RU.end());
    RU.swap(new_u); RV.swap(new_v);
    S.load[ru] = head_u + tail_v;
    S.load[rv] = head_v + tail_u;
    S.index_route(ru); S.index_route(rv);
    mark(ru); mark(rv);
    return true;
  }

  // relocate the pair (u, succ u) after v, optionally reversed
  // (the classical CVRP pair-relocation neighborhood; round-4: the missing
  // pair moves cost ~1% final tour quality vs the reference LS in A/B)
  bool try_relocate_pair(int u, int v, bool reversed) {
    int ru = S.route_of[u], pu = S.pos_of[u];
    std::vector<int>& RU = S.routes[ru];
    if (pu + 1 >= (int)RU.size()) return false;    // u has no in-route succ
    int x = RU[pu + 1];
    if (v == x || v == u) return false;
    int rv = S.route_of[v], pv = S.pos_of[v];
    if (rv == ru && pv >= pu - 1 && pv <= pu + 1) return false;
    if (rv != ru && S.load[rv] + P.dem[u] + P.dem[x] > P.cap) return false;
    int p_u = pred_node(RU, pu), s_x = succ_node(RU, pu + 1);
    std::vector<int>& RV = S.routes[rv];
    int s_v = succ_node(RV, pv);
    double rem = P.d(p_u, s_x) - P.d(p_u, u) - P.d(x, s_x);
    double ins;
    if (!reversed) {
      ins = P.d(v, u) + P.d(x, s_v) - P.d(v, s_v);
    } else {
      ins = P.d(v, x) + P.d(u, s_v) - P.d(v, s_v)
            + P.d(x, u) - P.d(u, x);   // internal edge flips (asym metrics)
    }
    if (rem + ins >= -1e-9) return false;
    RU.erase(RU.begin() + pu, RU.begin() + pu + 2);
    int target = pv + 1;
    if (rv == ru && pu < target) target -= 2;
    if (!reversed) {
      RV.insert(RV.begin() + target, {u, x});
    } else {
      RV.insert(RV.begin() + target, {x, u});
    }
    if (rv != ru) {
      S.load[ru] -= P.dem[u] + P.dem[x];
      S.load[rv] += P.dem[u] + P.dem[x];
    }
    S.index_route(ru);
    if (rv != ru) S.index_route(rv);
    mark(ru); if (rv != ru) mark(rv);
    return true;
  }

  // swap the pair (u, succ u) with the single customer v (inter-route)
  bool try_swap_pair_single(int u, int v) {
    int ru = S.route_of[u], pu = S.pos_of[u];
    int rv = S.route_of[v], pv = S.pos_of[v];
    if (rv == ru) return false;
    std::vector<int>& RU = S.routes[ru];
    if (pu + 1 >= (int)RU.size()) return false;
    int x = RU[pu + 1];
    if (S.load[ru] - P.dem[u] - P.dem[x] + P.dem[v] > P.cap) return false;
    if (S.load[rv] - P.dem[v] + P.dem[u] + P.dem[x] > P.cap) return false;
    std::vector<int>& RV = S.routes[rv];
    int p_u = pred_node(RU, pu), s_x = succ_node(RU, pu + 1);
    int p_v = pred_node(RV, pv), s_v = succ_node(RV, pv);
    double delta = P.d(p_u, v) + P.d(v, s_x) - P.d(p_u, u) - P.d(x, s_x)
                 + P.d(p_v, u) + P.d(x, s_v) - P.d(p_v, v) - P.d(v, s_v);
    if (delta >= -1e-9) return false;
    RU.erase(RU.begin() + pu, RU.begin() + pu + 2);
    RU.insert(RU.begin() + pu, v);
    RV.erase(RV.begin() + pv);
    RV.insert(RV.begin() + pv, {u, x});
    S.load[ru] += P.dem[v] - P.dem[u] - P.dem[x];
    S.load[rv] += P.dem[u] + P.dem[x] - P.dem[v];
    S.index_route(ru); S.index_route(rv);
    mark(ru); mark(rv);
    return true;
  }

  // swap the pair (u, succ u) with the pair (v, succ v) (inter-route)
  bool try_swap_pair_pair(int u, int v) {
    int ru = S.route_of[u], pu = S.pos_of[u];
    int rv = S.route_of[v], pv = S.pos_of[v];
    if (rv == ru) return false;
    std::vector<int>& RU = S.routes[ru];
    std::vector<int>& RV = S.routes[rv];
    if (pu + 1 >= (int)RU.size() || pv + 1 >= (int)RV.size()) return false;
    int x = RU[pu + 1], y = RV[pv + 1];
    double dux = P.dem[u] + P.dem[x], dvy = P.dem[v] + P.dem[y];
    if (S.load[ru] - dux + dvy > P.cap) return false;
    if (S.load[rv] - dvy + dux > P.cap) return false;
    int p_u = pred_node(RU, pu), s_x = succ_node(RU, pu + 1);
    int p_v = pred_node(RV, pv), s_y = succ_node(RV, pv + 1);
    double delta = P.d(p_u, v) + P.d(y, s_x) - P.d(p_u, u) - P.d(x, s_x)
                 + P.d(p_v, u) + P.d(x, s_y) - P.d(p_v, v) - P.d(y, s_y);
    if (delta >= -1e-9) return false;
    RU[pu] = v; RU[pu + 1] = y;
    RV[pv] = u; RV[pv + 1] = x;
    S.load[ru] += dvy - dux;
    S.load[rv] += dux - dvy;
    S.index_route(ru); S.index_route(rv);
    mark(ru); mark(rv);
    return true;
  }

  // 2-opt* reversal variant: join head(u)+rev(head(v)) / rev(tail(u))+tail(v)
  bool try_two_opt_star_rev(int u, int v) {
    int ru = S.route_of[u], rv = S.route_of[v];
    if (ru == rv) return false;
    int pu = S.pos_of[u], pv = S.pos_of[v];
    std::vector<int>& RU = S.routes[ru];
    std::vector<int>& RV = S.routes[rv];
    double head_u = 0, head_v = 0;
    for (int t = 0; t <= pu; ++t) head_u += P.dem[RU[t]];
    for (int t = 0; t <= pv; ++t) head_v += P.dem[RV[t]];
    double tail_u = S.load[ru] - head_u, tail_v = S.load[rv] - head_v;
    if (head_u + head_v > P.cap || tail_u + tail_v > P.cap) return false;
    int su = succ_node(RU, pu), sv = succ_node(RV, pv);
    // symmetric-metric delta (interior + depot edges reverse in place),
    // matching the classical 2-opt* second variant
    double delta = P.d(u, v) + P.d(su, sv) - P.d(u, su) - P.d(v, sv);
    if (delta >= -1e-9) return false;
    std::vector<int> new_u(RU.begin(), RU.begin() + pu + 1);
    new_u.insert(new_u.end(), RV.rend() - (pv + 1), RV.rend());
    std::vector<int> new_v(RU.rbegin(), RU.rbegin() + (RU.size() - pu - 1));
    new_v.insert(new_v.end(), RV.begin() + pv + 1, RV.end());
    RU.swap(new_u); RV.swap(new_v);
    S.load[ru] = head_u + head_v;
    S.load[rv] = tail_u + tail_v;
    S.index_route(ru); S.index_route(rv);
    mark(ru); mark(rv);
    return true;
  }

  // Test all RI moves for node u against its granular neighborhood.
  bool improve_node(int u) {
    for (int v : P.nbr[u]) {
      if (try_relocate(u, v)) return true;
      if (try_relocate_pair(u, v, false)) return true;
      if (try_relocate_pair(u, v, true)) return true;
      if (v > u && try_swap(u, v)) return true;
      if (try_swap_pair_single(u, v)) return true;
      if (v > u && try_swap_pair_pair(u, v)) return true;
      if (try_two_opt_intra(u, v)) return true;
      if (try_two_opt_star(u, v)) return true;
      if (try_two_opt_star_rev(u, v)) return true;
    }
    return false;
  }

  // One full RI sweep; returns true if any move was applied.
  bool ri_sweep() {
    bool any = false;
    for (int u = 1; u < P.n && !out_of_budget(); ++u) {
      if (S.route_of[u] < 0) continue;
      // freshness: skip u unless its route or a neighbor's route changed
      // since u was last tested
      uint64_t tested = node_tested[u];
      bool fresh = route_changed[S.route_of[u]] < tested;
      if (fresh) {
        for (int v : P.nbr[u])
          if (S.route_of[v] >= 0 && route_changed[S.route_of[v]] >= tested) {
            fresh = false;
            break;
          }
      }
      if (fresh) continue;
      node_tested[u] = clock + 1;
      while (improve_node(u)) {
        ++moves;
        any = true;
        if (out_of_budget()) break;
      }
    }
    return any;
  }

  // Best insertion of u into route r given that the customer at v_pos will
  // be removed. Returns the POST-REMOVAL insertion index in *out_pos.
  // Candidates: the best memo position not adjacent to v (its neighbor terms
  // are unchanged by the removal) plus inserting u exactly in v's place
  // (Vidal's "in place of v" case).
  double best_insert_avoiding(int u, int r, int v_pos, int* out_pos) {
    const std::vector<int>& R = S.routes[r];
    double best = 1e30; int bpos = -1;
    ThreeBest& tb = best3(u, r);
    for (int t = 0; t < 3; ++t) {
      if (tb.pos[t] < 0) break;
      if (tb.pos[t] == v_pos || tb.pos[t] == v_pos + 1) continue;
      if (tb.delta[t] < best) {
        best = tb.delta[t];
        bpos = tb.pos[t] - (tb.pos[t] > v_pos ? 1 : 0);
      }
      break;  // memo is sorted; first non-adjacent candidate is the best
    }
    {
      int p = pred_node(R, v_pos), s = succ_node(R, v_pos);
      double in_place = P.d(p, u) + P.d(u, s) - P.d(p, s);
      if (in_place < best) { best = in_place; bpos = v_pos; }
    }
    if (bpos < 0) {
      // all three memo slots were adjacent to v: exact scan fallback
      for (int pos = 0; pos <= (int)R.size(); ++pos) {
        if (pos == v_pos || pos == v_pos + 1) continue;
        double dlt = insertion_delta(P, R, pos, u);
        if (dlt < best) {
          best = dlt;
          bpos = pos - (pos > v_pos ? 1 : 0);
        }
      }
    }
    *out_pos = bpos;
    return best;
  }

  // Best SWAP* exchange between routes r1 and r2; apply if improving.
  bool swap_star_pair(int r1, int r2) {
    double best_delta = -1e-9;
    int bi = -1, bj = -1, bu = -1, bv = -1, bpu2 = -1, bpv1 = -1;
    for (int i = 0; i < (int)S.routes[r1].size(); ++i) {
      int u = S.routes[r1][i];
      double rem_u = removal_delta(P, S.routes[r1], i);
      for (int j = 0; j < (int)S.routes[r2].size(); ++j) {
        int v = S.routes[r2][j];
        if (S.load[r1] - P.dem[u] + P.dem[v] > P.cap) continue;
        if (S.load[r2] - P.dem[v] + P.dem[u] > P.cap) continue;
        double rem_v = removal_delta(P, S.routes[r2], j);
        // cheap lower bound before the exact insertion probe: removal gains
        // plus the best unconstrained insertions can't beat best_delta
        int pu2, pv1;
        double ins_u = best_insert_avoiding(u, r2, j, &pu2);
        double ins_v = best_insert_avoiding(v, r1, i, &pv1);
        double delta = rem_u + rem_v + ins_u + ins_v;
        if (delta < best_delta && pu2 >= 0 && pv1 >= 0) {
          best_delta = delta;
          bi = i; bj = j; bu = u; bv = v; bpu2 = pu2; bpv1 = pv1;
        }
      }
    }
    if (bi < 0) return false;
    std::vector<int>& R1 = S.routes[r1];
    std::vector<int>& R2 = S.routes[r2];
    R1.erase(R1.begin() + bi);
    R2.erase(R2.begin() + bj);
    R1.insert(R1.begin() + bpv1, bv);
    R2.insert(R2.begin() + bpu2, bu);
    S.load[r1] += P.dem[bv] - P.dem[bu];
    S.load[r2] += P.dem[bu] - P.dem[bv];
    S.index_route(r1); S.index_route(r2);
    mark(r1); mark(r2);
    return true;
  }

  // One SWAP* sweep over sector-overlapping, recently-modified route pairs.
  bool swap_star_sweep() {
    bool any = false;
    for (int r1 = 0; r1 < nr && !out_of_budget(); ++r1) {
      if (S.routes[r1].empty()) continue;
      for (int r2 = r1 + 1; r2 < nr; ++r2) {
        if (S.routes[r2].empty()) continue;
        uint64_t& seen = pair_tested[(size_t)r1 * nr + r2];
        if (route_changed[r1] < seen && route_changed[r2] < seen) continue;
        if (!sectors_overlap(get_sector(r1), get_sector(r2))) {
          seen = clock + 1;
          continue;
        }
        seen = clock + 1;
        while (swap_star_pair(r1, r2)) {
          ++moves;
          any = true;
          seen = clock + 1;
          if (out_of_budget()) break;
        }
        if (out_of_budget()) break;
      }
    }
    return any;
  }

  int run(bool use_swap_star) {
    bool improved = true;
    while (improved && !out_of_budget()) {
      // RI descent to a local optimum first; SWAP* only explores the
      // expensive inter-route neighborhood from RI-stable solutions (the
      // reference's ordering: SWAP* after the RI move loop,
      // LocalSearch.cpp:62-96)
      while (ri_sweep() && !out_of_budget()) {}
      improved = use_swap_star && !out_of_budget() && swap_star_sweep();
    }
    return moves;
  }
};

double total_cost(const Problem& P, const Solution& S) {
  double c = 0;
  for (auto& r : S.routes) c += route_cost(P, r);
  return c;
}

// Run the full improvement loop (RI moves + optional SWAP*) until a local
// optimum, `count_limit` applied moves, or `time_limit_s` of wall clock.
int improve(const Problem& P, Solution& S, int count_limit,
            bool use_swap_star, double time_limit_s = 0.0) {
  Engine eng(P, S, count_limit, time_limit_s);
  return eng.run(use_swap_star);
}

// ---------------------------------------------------------------------------
// Hybrid genetic search (the TPU-era equivalent of the reference's vendored
// HGS GA tier — Genetic/Population/Split, cvrp_nls/HGS-CVRP-main/Program/
// {Genetic,Population,Split}.cpp; SURVEY §2.2 N5). Fresh implementation from
// the published algorithm (Vidal 2022): giant-tour chromosome, optimal Split
// decoding under hard capacity, OX crossover, education by the local-search
// engine above, and population management with biased fitness
// (cost rank + broken-pairs diversity rank).
// ---------------------------------------------------------------------------
struct Indiv {
  std::vector<int> tour;                 // giant tour (customers 1..n-1)
  std::vector<std::vector<int>> routes;  // Split/LS result
  double cost = 1e30;
};

// Optimal split of a giant tour into capacity-feasible routes: Bellman over
// prefix positions; inner loop bounded by capacity so ~O(m · max_route_len).
bool split_tour(const Problem& P, const std::vector<int>& tour, Indiv& out) {
  int m = (int)tour.size();
  std::vector<double> dp(m + 1, 1e30);
  std::vector<int> pred(m + 1, -1);
  dp[0] = 0.0;
  for (int i = 0; i < m; ++i) {
    if (dp[i] >= 1e29) continue;
    double load = 0.0, inner = 0.0;
    for (int j = i; j < m; ++j) {
      load += P.dem[tour[j]];
      if (load > P.cap) break;
      if (j > i) inner += P.d(tour[j - 1], tour[j]);
      double c = dp[i] + P.d(0, tour[i]) + inner + P.d(tour[j], 0);
      if (c < dp[j + 1]) { dp[j + 1] = c; pred[j + 1] = i; }
    }
  }
  if (dp[m] >= 1e29) return false;  // some demand exceeds capacity
  out.tour = tour;
  out.routes.clear();
  std::vector<std::pair<int, int>> segs;
  for (int j = m; j > 0; j = pred[j]) segs.push_back({pred[j], j});
  for (auto it = segs.rbegin(); it != segs.rend(); ++it)
    out.routes.emplace_back(tour.begin() + it->first,
                            tour.begin() + it->second);
  out.cost = dp[m];
  return true;
}

// OX (order crossover) on giant tours.
std::vector<int> ox_crossover(const std::vector<int>& a,
                              const std::vector<int>& b, int n,
                              std::mt19937& rng) {
  int m = (int)a.size();
  std::uniform_int_distribution<int> U(0, m - 1);
  int s = U(rng), e = U(rng);
  if (s > e) std::swap(s, e);
  std::vector<int> child(m, -1);
  std::vector<char> used(n, 0);
  for (int i = s; i <= e; ++i) { child[i] = a[i]; used[a[i]] = 1; }
  int k = (e + 1) % m;
  for (int t = 0; t < m; ++t) {
    int v = b[(e + 1 + t) % m];
    if (!used[v]) { child[k] = v; k = (k + 1) % m; }
  }
  return child;
}

// Broken-pairs distance: fraction of a customer's route neighbors (pred,
// succ, depot included) not shared between two individuals.
double broken_pairs(const Indiv& A, const Indiv& B, int n) {
  auto adj = [n](const Indiv& X) {
    std::vector<std::array<int, 2>> a((size_t)n, {0, 0});
    for (const auto& r : X.routes)
      for (int p = 0; p < (int)r.size(); ++p) {
        a[r[p]][0] = p > 0 ? r[p - 1] : 0;
        a[r[p]][1] = p + 1 < (int)r.size() ? r[p + 1] : 0;
      }
    return a;
  };
  auto aa = adj(A), ab = adj(B);
  int diff = 0;
  for (int v = 1; v < n; ++v)
    for (int t = 0; t < 2; ++t)
      if (aa[v][t] != ab[v][0] && aa[v][t] != ab[v][1]) ++diff;
  return n > 1 ? diff / (2.0 * (n - 1)) : 0.0;
}

struct Population {
  int n, mu, nb_elite, nb_close;
  std::vector<Indiv> pool;

  // Biased fitness ranks (Vidal 2022 §3.4): fit rank on cost + diversity
  // rank on mean broken-pairs distance to the nb_close closest individuals.
  std::vector<double> biased_fitness() const {
    int N = (int)pool.size();
    std::vector<int> order(N);
    for (int i = 0; i < N; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int x, int y) {
      return pool[x].cost < pool[y].cost;
    });
    std::vector<double> fit_rank(N), div(N);
    for (int r = 0; r < N; ++r) fit_rank[order[r]] = r;
    std::vector<double> drow(N);
    for (int i = 0; i < N; ++i) {
      for (int j = 0; j < N; ++j)
        drow[j] = i == j ? 1e30 : broken_pairs(pool[i], pool[j], n);
      int k = std::min(nb_close, N - 1);
      std::partial_sort(drow.begin(), drow.begin() + k, drow.end());
      double s = 0;
      for (int t = 0; t < k; ++t) s += drow[t];
      div[i] = k > 0 ? s / k : 0.0;
    }
    std::vector<int> dorder(N);
    for (int i = 0; i < N; ++i) dorder[i] = i;
    std::sort(dorder.begin(), dorder.end(), [&](int x, int y) {
      return div[x] > div[y];  // most diverse first (best rank)
    });
    std::vector<double> bf(N);
    double w = N > 0 ? 1.0 - (double)nb_elite / N : 1.0;
    for (int r = 0; r < N; ++r) {
      int i = dorder[r];
      bf[i] = fit_rank[i] + w * r;
    }
    return bf;
  }

  // Drop the worst-biased-fitness individuals (clones first) down to mu.
  void select_survivors() {
    while ((int)pool.size() > mu) {
      auto bf = biased_fitness();
      int worst = -1;
      bool worst_clone = false;
      for (int i = 0; i < (int)pool.size(); ++i) {
        bool clone = false;
        for (int j = 0; j < (int)pool.size() && !clone; ++j)
          clone = i != j && broken_pairs(pool[i], pool[j], n) < 1e-12;
        if (worst < 0 || (clone && !worst_clone) ||
            (clone == worst_clone && bf[i] > bf[worst])) {
          worst = i;
          worst_clone = clone;
        }
      }
      pool.erase(pool.begin() + worst);
    }
  }

  const Indiv& tournament(std::mt19937& rng,
                          const std::vector<double>& bf) const {
    std::uniform_int_distribution<int> U(0, (int)pool.size() - 1);
    int a = U(rng), b = U(rng);
    return bf[a] <= bf[b] ? pool[a] : pool[b];
  }
};

// Owns instance data + k-NN lists for repeated local-search calls.
struct Context {
  Problem P;
};

Solution decode_routes(const Problem& P, const int* routes_flat,
                       const int* route_lens, int n_routes) {
  Solution S;
  S.routes.resize(n_routes);
  int off = 0;
  for (int r = 0; r < n_routes; ++r) {
    S.routes[r].assign(routes_flat + off, routes_flat + off + route_lens[r]);
    off += route_lens[r];
  }
  S.rebuild(P);
  return S;
}

int encode_routes(const Solution& S, int* routes_flat, int* route_lens) {
  int off = 0, out_r = 0;
  for (auto& r : S.routes) {
    if (r.empty()) continue;
    std::memcpy(routes_flat + off, r.data(), r.size() * sizeof(int));
    route_lens[out_r++] = (int)r.size();
    off += (int)r.size();
  }
  return out_r;
}

}  // namespace

extern "C" {

// Reusable local-search context: holds pointers to the caller's dist /
// demands / coords buffers (which must outlive the context) and the computed
// k-nearest-neighbor lists. Safe for concurrent cvrp_ls_improve calls.
void* cvrp_ls_context_new(int n, const double* dist, const double* demands,
                          double capacity, const double* coords,
                          int k_granular) {
  Context* ctx = new Context{
      Problem{n, dist, demands, coords, capacity,
              k_granular > 0 ? k_granular : 20, {}, {}}};
  ctx->P.build_neighbors();
  return ctx;
}

void cvrp_ls_context_free(void* ctx) { delete (Context*)ctx; }

// Improve a CVRP solution in place using a prebuilt context.
//   routes_flat / route_lens encode `n_routes` depot-free routes.
//   count_limit caps applied moves; time_limit_s (<=0 disables) caps wall
//   clock so a pathological instance can't stall the training loop.
// Returns the resulting number of routes (empty routes dropped).
int cvrp_ls_improve(void* ctx_v, int* routes_flat, int* route_lens,
                    int n_routes, int count_limit, int use_swap_star,
                    double time_limit_s) {
  Context* ctx = (Context*)ctx_v;
  Solution S = decode_routes(ctx->P, routes_flat, route_lens, n_routes);
  improve(ctx->P, S, count_limit, use_swap_star != 0, time_limit_s);
  return encode_routes(S, routes_flat, route_lens);
}

// One-shot entry (builds and frees a context around cvrp_ls_improve).
// `coords` may be NULL: sector pruning then degrades to pair-version memos.
int cvrp_local_search(int n, const double* dist, const double* demands,
                      double capacity, const double* coords,
                      int* routes_flat, int* route_lens, int n_routes,
                      int count_limit, int k_granular, int use_swap_star,
                      double time_limit_s) {
  void* ctx = cvrp_ls_context_new(n, dist, demands, capacity, coords,
                                  k_granular);
  int out = cvrp_ls_improve(ctx, routes_flat, route_lens, n_routes,
                            count_limit, use_swap_star, time_limit_s);
  cvrp_ls_context_free(ctx);
  return out;
}

// Full hybrid genetic search for one CVRP instance (the equivalent of the
// reference's exposed-but-unused `solve_cvrp*` entries, C_Interface.cpp:50-127,
// backed by Genetic/Population/Split — SURVEY §2.2 N5).
//
//   max_iters          total crossover+educate iterations cap
//   no_improve_limit   stop after this many iterations without a new best
//   time_limit_s       wall-clock cap (<=0 disables)
//   seed               deterministic RNG seed
//   ls_count           move cap per education call
//   routes_flat        out, capacity >= n-1 ints
//   route_lens         out, capacity >= n ints
//   n_routes_out       out, number of routes written
// Returns the best solution cost (or a huge value if infeasible, i.e. some
// demand exceeds capacity).
double cvrp_solve(int n, const double* dist, const double* demands,
                  double capacity, int max_iters, int no_improve_limit,
                  double time_limit_s, unsigned int seed, int ls_count,
                  int k_granular, int* routes_flat, int* route_lens,
                  int* n_routes_out) {
  Problem P{n, dist, demands, nullptr, capacity,
            k_granular > 0 ? k_granular : 20, {}, {}};
  P.build_neighbors();
  std::mt19937 rng(seed);
  const int MU = 12, LAMBDA = 20, NB_ELITE = 4, NB_CLOSE = 3;

  auto t0 = std::chrono::steady_clock::now();
  auto elapsed = [&] {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now() - t0).count();
  };

  // Educate an individual: local search on its routes, then rebuild the
  // giant tour from the improved routes (chromT <- chromR, as in HGS).
  auto educate = [&](Indiv& ind) {
    Solution S;
    S.routes = ind.routes;
    S.rebuild(P);
    improve(P, S, ls_count, true);
    ind.routes.clear();
    ind.tour.clear();
    for (auto& r : S.routes)
      if (!r.empty()) {
        ind.routes.push_back(r);
        ind.tour.insert(ind.tour.end(), r.begin(), r.end());
      }
    ind.cost = total_cost(P, S);
  };

  std::vector<int> base;
  for (int v = 1; v < n; ++v) base.push_back(v);

  Population pop{n, MU, NB_ELITE, NB_CLOSE, {}};
  Indiv best;
  for (int i = 0; i < MU && (int)base.size() > 0; ++i) {
    std::vector<int> tour = base;
    std::shuffle(tour.begin(), tour.end(), rng);
    Indiv ind;
    if (!split_tour(P, tour, ind)) return 1e30;
    educate(ind);
    if (ind.cost < best.cost) best = ind;
    pop.pool.push_back(std::move(ind));
  }
  if (base.empty()) { *n_routes_out = 0; return 0.0; }

  int since_best = 0;
  for (int it = 0; it < max_iters && since_best < no_improve_limit; ++it) {
    if (time_limit_s > 0 && elapsed() > time_limit_s) break;
    auto bf = pop.biased_fitness();
    const Indiv& pa = pop.tournament(rng, bf);
    const Indiv& pb = pop.tournament(rng, bf);
    Indiv child;
    if (!split_tour(P, ox_crossover(pa.tour, pb.tour, n, rng), child))
      continue;
    educate(child);
    if (child.cost < best.cost - 1e-9) {
      best = child;
      since_best = 0;
    } else {
      ++since_best;
    }
    pop.pool.push_back(std::move(child));
    if ((int)pop.pool.size() >= MU + LAMBDA) pop.select_survivors();
  }

  int off = 0, out_r = 0;
  for (auto& r : best.routes) {
    std::memcpy(routes_flat + off, r.data(), r.size() * sizeof(int));
    route_lens[out_r++] = (int)r.size();
    off += (int)r.size();
  }
  *n_routes_out = out_r;
  return best.cost;
}

// Total cost of an encoded solution (for tests/debugging).
double cvrp_solution_cost(int n, const double* dist, const int* routes_flat,
                          const int* route_lens, int n_routes) {
  double c = 0;
  int off = 0;
  for (int r = 0; r < n_routes; ++r) {
    int m = route_lens[r];
    if (m > 0) {
      c += dist[routes_flat[off]];  // d(0, first)
      for (int t = 0; t + 1 < m; ++t)
        c += dist[(size_t)routes_flat[off + t] * n + routes_flat[off + t + 1]];
      c += dist[(size_t)routes_flat[off + m - 1] * n];  // d(last, 0)
    }
    off += m;
  }
  return c;
}

}  // extern "C"
