// Native BVH build: the binned-SAH skip-link build and its 8-wide regrouping.
//
// Counterpart of core/bvh.py's `build_bvh` (with `_sah_split`) and `widen_bvh`,
// operation for operation, so every array is the numpy build's, bit for bit:
//   * triangle bounds kept as f32 (the min or max of f32 vertices, which numpy's f64
//     copy holds exactly) and widened to f64 where used; f64 centroids;
//   * min/max pick as numpy's np.minimum/np.maximum do, the second operand on ties
//     (which decides the sign of a zero), and reductions run first to last;
//   * 16 bins on the longest centroid axis (the first on ties), the prefix and suffix
//     boxes, the areas summed in numpy's order, cost = A_L * n_L + A_R * n_R, the
//     first minimum; this file must be built with -ffp-contract=off, since an FMA
//     would round the areas and costs differently;
//   * stable partitions, in place: a node's triangles are one range of one array,
//     and its groups are consecutive subranges of it, so a leaf's range is its
//     [tri_start, tri_start + tri_count) and the array's ids are `order` at the end.
// Where the numpy build takes its median split (degenerate centroids, or no split
// with a finite cost) it calls np.argpartition, whose order this file does not copy:
// the build returns a status instead, and the caller runs the numpy build.
//
// Threads. Once a node's groups are fixed, the subtree of each group reads and writes
// only its own range of the triangle array (and the same range of the partition's
// spill and bin buffers, which are indexed as that array is). So a group of at least
// kTaskTris triangles that is no leaf is built as a task, by whichever thread takes it
// first: the calling thread or a worker of the process's pool (one a further CPU the
// process may run on). A task writes node arrays of its own and records, in pre-order,
// items that are its nodes or the tasks it handed on, a node's skip link as the item
// after its subtree. The join places each task's nodes after the subtrees before them
// and maps items to node ids, so every array is the one-thread build's, whatever thread
// built what and in what order. A task that fails stops where the one-thread build
// would stop; the build returns the first failure in pre-order and writes no output
// array. A build with no such group runs on the calling thread alone. C ABI for ctypes.

#include <sched.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kBins = 16;

// The fewest triangles of a subtree built as a task. Swept on the H100's host (8 CPUs),
// the 102,404 triangles of sphere_field(80, 3) at leaf 6, branching 8, every value in
// turn, 80 rounds (PERF.md): medians from 512, 1,024, 2,048 and 4,096 triangles 15.04,
// 15.46, 14.75 and 17.58 ms (82, 66, 17 and 8 tasks), one thread 49.0; on a second
// host, 30 builds a value, 11.0, 11.6, 12.1 and 11.5 ms, one thread 28.2. 512 keeps
// the most tasks to share out when a thread is held up, within noise of the fastest;
// sphere_field()'s 5,124 triangles then run 7 tasks at leaf 32, 1.07 ms against 1.20
// on one thread.
constexpr int64_t kTaskTris = 512;

// Build statuses (negative): the caller runs the numpy build instead.
constexpr int64_t kDegenerate = -1;  // a group's centroids span less than 1e-12
constexpr int64_t kNoFiniteCost = -2;
constexpr int64_t kNonFinite = -3;   // a vertex is inf or NaN
constexpr int64_t kBadArgs = -4;     // what the numpy build rejects on its own

template <typename T> inline T pick_min(T a, T b) { return a < b ? a : b; }
template <typename T> inline T pick_max(T a, T b) { return a > b ? a : b; }

// Surface-area proxy of a box, as core/bvh.py's `areas` sums it.
inline double area(const double* mn, const double* mx) {
  double d0 = pick_max(mx[0] - mn[0], 0.0);
  double d1 = pick_max(mx[1] - mn[1], 0.0);
  double d2 = pick_max(mx[2] - mn[2], 0.0);
  return d0 * d1 + d1 * d2 + d2 * d0;
}

// A triangle's bounds and its index; the build partitions these in place, so every
// pass over a node's triangles reads memory in order.
struct Tri {
  float mn[3];
  float mx[3];
  int32_t id;

  double centroid(int a) const { return (double(mn[a]) + double(mx[a])) * 0.5; }
};

// Scratch memory of the calling thread's builds, kept between calls: a build of n
// triangles touches about 60n bytes, and fresh pages would cost more than the build's
// arithmetic. Each build writes every entry it reads; nothing of one build reaches
// the next.
struct Scratch {
  std::vector<Tri> tris;
  std::vector<Tri> spill;
  std::vector<int32_t> bins;
};

// A subtree built by one thread: its nodes in arrays of its own and its items in
// pre-order, each a node (>= 0: its index here) or a task it handed on (~k:
// children[k]).
struct Task {
  int64_t b, e;                   // its range of the triangle array
  std::vector<float> mn, mx;      // 3 a node
  std::vector<int32_t> start, count;
  std::vector<int64_t> next;      // a node's skip link: the item after its subtree
  std::vector<int64_t> items;
  std::vector<std::unique_ptr<Task>> children;
  int64_t status = 0;
  int64_t size = 0;               // nodes of the subtree, its tasks' too (the join's)

  Task(int64_t b_, int64_t e_) : b(b_), e(e_) {}
};

struct Build;

// A task handed to the pool, and its build.
struct Job {
  Build* build;
  Task* task;
};

// The process's worker threads, one for each CPU it may run on beyond the caller's,
// started by the first build that hands a task on and kept for the process (starting
// 7 threads and joining them costs 0.5-1 ms on the H100's host). A caller runs its
// own build's queued tasks while it waits, so a build completes with any number of
// workers. A child process of a fork makes its own pool.
struct Pool {
  std::mutex m;                   // guards the queue and every build's count
  std::condition_variable work_cv;
  std::deque<Job> queue;
  pid_t pid = getpid();

  static Pool& get() {
    static std::mutex made;
    static Pool* current = nullptr;
    std::lock_guard<std::mutex> lk(made);
    if (current == nullptr || current->pid != getpid()) {
      current = new Pool();       // never freed: its threads live as long as the process
      current->start();
    }
    return *current;
  }

  void start() {
    cpu_set_t set;
    int cpus = sched_getaffinity(0, sizeof(set), &set) == 0
                   ? CPU_COUNT(&set)
                   : int(std::thread::hardware_concurrency());
    for (int w = 1; w < cpus; ++w) {
      try {
        std::thread([this] { serve(); }).detach();
      } catch (const std::system_error&) {
        break;                    // no more threads: the ones there do the work
      }
    }
  }

  void serve();
};

// One build: the arrays its tasks share, and its count of tasks queued or running.
struct Build {
  Tri* tris;                      // (n,): a node's triangles are one range of it
  Tri* spill;                     // (n,), indexed as `tris`
  int32_t* bins;                  // (n,), indexed as `tris`
  int64_t leaf_size;
  int64_t branching;
  Pool* pool = nullptr;           // set by the first task handed on, the root's
  std::condition_variable done_cv;
  int64_t tasks_left = 0;         // the pool's mutex guards it

  void run(Task& t);

  // Queue a task; only the thread that runs it touches it until the build's join.
  void hand_on(Task* t) {
    if (pool == nullptr) pool = &Pool::get();
    {
      std::lock_guard<std::mutex> lk(pool->m);
      ++tasks_left;
      pool->queue.push_back(Job{this, t});
    }
    pool->work_cv.notify_one();
    done_cv.notify_one();         // the caller may take it while it waits
  }

  // Build the root task on the calling thread, then run this build's queued tasks
  // until none is queued or running.
  void run_all(Task& root) {
    run(root);
    if (pool == nullptr) return;
    std::unique_lock<std::mutex> lk(pool->m);
    while (tasks_left > 0) {
      auto it = std::find_if(pool->queue.begin(), pool->queue.end(),
                             [this](const Job& j) { return j.build == this; });
      if (it == pool->queue.end()) {
        done_cv.wait(lk);
        continue;
      }
      Task* t = it->task;
      pool->queue.erase(it);
      lk.unlock();
      run(*t);
      lk.lock();
      --tasks_left;
    }
  }
};

void Pool::serve() {
  std::unique_lock<std::mutex> lk(m);
  for (;;) {
    work_cv.wait(lk, [this] { return !queue.empty(); });
    Job j = queue.front();
    queue.pop_front();
    lk.unlock();
    j.build->run(*j.task);
    lk.lock();
    // Under the lock: the build's caller cannot see 0 and end the build before this.
    if (--j.build->tasks_left == 0) j.build->done_cv.notify_all();
  }
}

struct Builder {
  Build& bld;
  Task& task;

  // Binned-SAH split of tris[b, e): the end of the left side, or a status.
  int64_t split(int64_t b, int64_t e) {
    Tri* tris = bld.tris;
    int32_t* bins = bld.bins;
    double cmin[3], cmax[3];
    for (int a = 0; a < 3; ++a) cmin[a] = cmax[a] = tris[b].centroid(a);
    for (int64_t i = b + 1; i < e; ++i)
#pragma GCC unroll 3
      for (int a = 0; a < 3; ++a) {
        double c = tris[i].centroid(a);
        cmin[a] = pick_min(cmin[a], c);
        cmax[a] = pick_max(cmax[a], c);
      }
    int axis = 0;
    double best_ext = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a) {
      double ext = cmax[a] - cmin[a];
      if (ext > best_ext) { axis = a; best_ext = ext; }
    }
    double lo = cmin[axis], hi = cmax[axis];
    if (hi - lo < 1e-12) return kDegenerate;

    double scale = double(kBins) / (hi - lo);
    int64_t counts[kBins] = {0};
    double bmin[kBins][3], bmax[kBins][3];
    for (int k = 0; k < kBins; ++k)
      for (int a = 0; a < 3; ++a) { bmin[k][a] = INFINITY; bmax[k][a] = -INFINITY; }
    for (int64_t i = b; i < e; ++i) {
      const Tri& t = tris[i];
      int64_t k = int64_t((t.centroid(axis) - lo) * scale);
      if (k > kBins - 1) k = kBins - 1;
      bins[i] = int32_t(k);
      ++counts[k];
#pragma GCC unroll 3
      for (int a = 0; a < 3; ++a) {
        bmin[k][a] = pick_min(bmin[k][a], double(t.mn[a]));
        bmax[k][a] = pick_max(bmax[k][a], double(t.mx[a]));
      }
    }

    double lmin[kBins][3], lmax[kBins][3], rmin[kBins][3], rmax[kBins][3];
    for (int a = 0; a < 3; ++a) {
      lmin[0][a] = bmin[0][a];
      lmax[0][a] = bmax[0][a];
      rmin[kBins - 1][a] = bmin[kBins - 1][a];
      rmax[kBins - 1][a] = bmax[kBins - 1][a];
    }
    for (int k = 1; k < kBins; ++k)
      for (int a = 0; a < 3; ++a) {
        lmin[k][a] = pick_min(lmin[k - 1][a], bmin[k][a]);
        lmax[k][a] = pick_max(lmax[k - 1][a], bmax[k][a]);
      }
    for (int k = kBins - 2; k >= 0; --k)
      for (int a = 0; a < 3; ++a) {
        rmin[k][a] = pick_min(rmin[k + 1][a], bmin[k][a]);
        rmax[k][a] = pick_max(rmax[k + 1][a], bmax[k][a]);
      }

    int64_t n = e - b, nl = 0;
    int s_best = -1;
    double c_best = INFINITY;
    for (int s = 0; s < kBins - 1; ++s) {
      nl += counts[s];
      int64_t nr = n - nl;
      double cost = area(lmin[s], lmax[s]) * double(nl) +
                    area(rmin[s + 1], rmax[s + 1]) * double(nr);
      if (nl == 0 || nr == 0) cost = INFINITY;  // empty sides never win
      if (std::isfinite(cost) && (s_best < 0 || cost < c_best)) {
        s_best = s;
        c_best = cost;
      }
    }
    if (s_best < 0) return kNoFiniteCost;

    // Stable partition: bins <= s_best first, each side in its old order.
    Tri* spill = bld.spill + b;
    int64_t w = b, r = 0;
    for (int64_t i = b; i < e; ++i) {
      if (bins[i] <= s_best) tris[w++] = tris[i];
      else spill[r++] = tris[i];
    }
    std::copy(spill, spill + r, tris + w);
    return w;
  }

  // Emit the subtree of tris[b, e) in pre-order.
  void emit(int64_t b, int64_t e) {
    const Tri* tris = bld.tris;
    int64_t nid = int64_t(task.start.size());
    task.items.push_back(nid);
    float mn[3], mx[3];
    for (int a = 0; a < 3; ++a) { mn[a] = tris[b].mn[a]; mx[a] = tris[b].mx[a]; }
    for (int64_t i = b + 1; i < e; ++i)
#pragma GCC unroll 3
      for (int a = 0; a < 3; ++a) {
        mn[a] = pick_min(mn[a], tris[i].mn[a]);
        mx[a] = pick_max(mx[a], tris[i].mx[a]);
      }
    task.mn.insert(task.mn.end(), mn, mn + 3);
    task.mx.insert(task.mx.end(), mx, mx + 3);
    task.start.push_back(-1);
    task.count.push_back(0);
    task.next.push_back(-1);

    if (e - b <= bld.leaf_size) {
      task.start[nid] = int32_t(b);
      task.count[nid] = int32_t(e - b);
    } else {
      // Split the largest group until there are `branching`, each split replacing
      // its group in place (stable child order).
      std::vector<std::pair<int64_t, int64_t>> groups{{b, e}};
      while (int64_t(groups.size()) < bld.branching) {
        int64_t gi_best = -1, sz_best = bld.leaf_size;
        for (size_t gi = 0; gi < groups.size(); ++gi) {
          int64_t sz = groups[gi].second - groups[gi].first;
          if (sz > sz_best) { gi_best = int64_t(gi); sz_best = sz; }
        }
        if (gi_best < 0) break;  // nothing left to split
        auto g = groups[gi_best];
        int64_t m = split(g.first, g.second);
        if (m < 0) { task.status = m; return; }
        groups[gi_best] = {g.first, m};
        groups.insert(groups.begin() + gi_best + 1, {m, g.second});
      }
      for (const auto& g : groups) {
        int64_t sz = g.second - g.first;
        if (sz >= kTaskTris && sz > bld.leaf_size) {
          task.items.push_back(~int64_t(task.children.size()));
          task.children.push_back(std::make_unique<Task>(g.first, g.second));
          bld.hand_on(task.children.back().get());
        } else {
          emit(g.first, g.second);
          if (task.status < 0) return;
        }
      }
    }
    task.next[nid] = int64_t(task.items.size());
  }
};

void Build::run(Task& t) { Builder{*this, t}.emit(t.b, t.e); }

// The first failure in pre-order: a task stops at its failure, after every task it
// handed on.
int64_t first_status(const Task& t) {
  for (const auto& c : t.children)
    if (int64_t s = first_status(*c); s < 0) return s;
  return t.status;
}

int64_t count_tasks(const Task& t) {
  int64_t n = int64_t(t.children.size());
  for (const auto& c : t.children) n += count_tasks(*c);
  return n;
}

int64_t measure(Task& t) {
  t.size = int64_t(t.start.size());
  for (auto& c : t.children) t.size += measure(*c);
  return t.size;
}

struct Out {
  float* nodes_min;
  float* nodes_max;
  int32_t* skip;
  int32_t* tri_start;
  int32_t* tri_count;
};

// Write task t's subtree from node id `base` on (its tasks' sizes measured).
void place(const Task& t, int64_t base, const Out& out) {
  size_t n_items = t.items.size();
  std::vector<int64_t> at(n_items + 1);  // each item's first node id
  int64_t id = base;
  for (size_t i = 0; i < n_items; ++i) {
    at[i] = id;
    int64_t it = t.items[i];
    id += it >= 0 ? 1 : t.children[~it]->size;
  }
  at[n_items] = id;
  for (size_t i = 0; i < n_items; ++i) {
    int64_t it = t.items[i];
    if (it < 0) {
      place(*t.children[~it], at[i], out);
      continue;
    }
    int64_t nid = at[i];
    for (int a = 0; a < 3; ++a) {
      out.nodes_min[3 * nid + a] = t.mn[3 * it + a];
      out.nodes_max[3 * nid + a] = t.mx[3 * it + a];
    }
    out.skip[nid] = int32_t(at[t.next[it]]);
    out.tri_start[nid] = t.start[it];
    out.tri_count[nid] = t.count[it];
  }
}

}  // namespace

extern "C" {

// Build the flattened skip-link BVH of n triangles (p1, p2, p3: (n, 3) f32).
// The node arrays hold room for 2n - 1 nodes; `order` holds n entries. Returns the
// number of nodes, or a negative status where the numpy build must run instead (the
// output arrays then hold nothing). *tasks is the number of subtrees built as tasks.
int64_t oclpt_bvh_build(const float* p1, const float* p2, const float* p3, int64_t n,
                        int64_t leaf_size, int64_t branching, float* nodes_min,
                        float* nodes_max, int32_t* skip, int32_t* tri_start,
                        int32_t* tri_count, int32_t* order, int64_t* tasks) {
  *tasks = 0;
  if (n < 1 || n > INT32_MAX || leaf_size < 1 || branching < 2) return kBadArgs;
  static thread_local Scratch scratch;
  if (int64_t(scratch.tris.size()) < n) {
    scratch.tris.resize(n);
    scratch.spill.resize(n);
    scratch.bins.resize(n);
  }
  Build bld;
  bld.tris = scratch.tris.data();
  bld.spill = scratch.spill.data();
  bld.bins = scratch.bins.data();
  bld.leaf_size = leaf_size;
  bld.branching = branching;
  for (int64_t i = 0; i < n; ++i) {
    Tri& t = bld.tris[i];
    for (int a = 0; a < 3; ++a) {
      float x = p1[3 * i + a], y = p2[3 * i + a], z = p3[3 * i + a];
      if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) return kNonFinite;
      t.mn[a] = pick_min(pick_min(x, y), z);
      t.mx[a] = pick_max(pick_max(x, y), z);
    }
    t.id = int32_t(i);
  }
  Task root(0, n);
  bld.run_all(root);
  *tasks = count_tasks(root);
  if (int64_t s = first_status(root); s < 0) return s;
  int64_t n_nodes = measure(root);
  place(root, 0, Out{nodes_min, nodes_max, skip, tri_start, tri_count});
  for (int64_t i = 0; i < n; ++i) order[i] = bld.tris[i].id;
  return n_nodes;
}

// Regroup a flattened BVH of n nodes into 8-wide groups (core/bvh.py widen_bvh).
// The outputs, (groups, max_children[, 3]), arrive filled with the empty slot's
// values; `groups` is 1 for a single-leaf tree, else the number of internal nodes.
// Returns the walk's stack depth (>= 1); -(i + 1) when node i has more than
// max_children children; 0 when a skip link leaves the tree (the caller's numpy
// code then decides).
int64_t oclpt_bvh_widen(const float* nodes_min, const float* nodes_max,
                        const int32_t* skip, const int32_t* tri_start,
                        const int32_t* tri_count, int64_t n, int64_t max_children,
                        int64_t groups, float* child_min, float* child_max,
                        int32_t* child_kind, int32_t* child_a, int32_t* child_b) {
  auto put_box = [&](int64_t gi, int64_t slot, int64_t c) {
    for (int a = 0; a < 3; ++a) {
      child_min[(gi * max_children + slot) * 3 + a] = nodes_min[3 * c + a];
      child_max[(gi * max_children + slot) * 3 + a] = nodes_max[3 * c + a];
    }
  };
  if (n == 1 || tri_count[0] != 0) {  // a single-leaf tree: slot 0 is the leaf
    put_box(0, 0, 0);
    child_kind[0] = 2;
    child_a[0] = tri_start[0];
    child_b[0] = tri_count[0];
    return 1;
  }
  std::vector<int64_t> gid(n, -1);
  int64_t g = 0;
  for (int64_t i = 0; i < n; ++i)
    if (tri_count[i] == 0) gid[i] = g++;
  if (g != groups) return 0;

  for (int64_t i = 0; i < n; ++i) {
    if (tri_count[i] != 0) continue;
    int64_t gi = gid[i], c = i + 1, slot = 0;
    while (c < skip[i]) {
      if (slot >= max_children) return -(i + 1);
      if (c < 0 || c >= n) return 0;
      int64_t at = gi * max_children + slot;
      put_box(gi, slot, c);
      if (tri_count[c] == 0) {
        child_kind[at] = 1;
        child_a[at] = int32_t(gid[c]);
      } else {
        child_kind[at] = 2;
        child_a[at] = tri_start[c];
        child_b[at] = tri_count[c];
      }
      c = skip[c];
      ++slot;
    }
  }

  // Stack depth: groups are numbered in pre-order, so children have larger ids and
  // one reverse sweep computes every subtree's depth.
  std::vector<int64_t> depth(g, 0);
  for (int64_t gi = g - 1; gi >= 0; --gi) {
    int64_t d = 1;
    for (int64_t slot = 0; slot < max_children; ++slot) {
      int64_t at = gi * max_children + slot;
      if (child_kind[at] == 1) {
        int64_t sub = child_a[at];
        if (sub < 0 || sub >= g) return 0;
        d = d > 1 + depth[sub] ? d : 1 + depth[sub];
      }
    }
    depth[gi] = d;
  }
  return depth[0];
}

}  // extern "C"
