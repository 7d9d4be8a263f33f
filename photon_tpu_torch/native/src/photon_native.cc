// photon_tpu_torch native runtime: C++ fast paths for the data/IO layer
// (the port's copy of photon_tpu/native/src/photon_native.cc).
//
// Reference parity: com.linkedin.photon.ml.index.PalDBIndexMap (an offline
// native key-value store for huge feature spaces) and the JVM Avro decoder
// behind com.linkedin.photon.ml.data.avro.AvroDataReader. The compute path
// is PyTorch/CUDA; this file is the host runtime AROUND it: a mmap-able
// open-addressing feature-index store and a columnar Avro
// TrainingExampleAvro block decoder that turns container-file blocks into
// numpy-ready arrays without touching the Python interpreter per record.
//
// C ABI only (consumed via ctypes; built by g++, no PyTorch headers).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ===========================================================================
// Hash store: feature key (bytes) -> dense id. Open addressing, FNV-1a,
// power-of-two buckets. Save format (little endian):
//   magic "PHIX1\0\0\0" | u64 n | u64 capacity | u64 blob_size |
//   buckets: capacity x { u64 hash; u64 key_off; u32 key_len; i32 id; }
//   key blob
// An open()ed store is mmap'd read-only (the PalDB analog: build offline,
// map at training/scoring time).
// ===========================================================================

static const uint64_t FNV_OFFSET = 1469598103934665603ULL;
static const uint64_t FNV_PRIME = 1099511628211ULL;

static inline uint64_t fnv1a(const uint8_t* data, uint32_t len) {
  uint64_t h = FNV_OFFSET;
  for (uint32_t i = 0; i < len; ++i) {
    h ^= data[i];
    h *= FNV_PRIME;
  }
  return h ? h : 1;  // 0 marks an empty bucket
}

struct Bucket {
  uint64_t hash;
  uint64_t key_off;
  uint32_t key_len;
  int32_t id;
};

struct Store {
  std::vector<Bucket> buckets;  // mutable mode
  std::vector<uint8_t> blob;    // mutable mode
  uint64_t n = 0;
  uint64_t capacity = 0;
  // mmap mode (read-only):
  const Bucket* mbuckets = nullptr;
  const uint8_t* mblob = nullptr;
  void* map_base = nullptr;
  size_t map_size = 0;

  bool mapped() const { return mbuckets != nullptr; }
  const Bucket* bucket_at(uint64_t i) const {
    return mapped() ? &mbuckets[i] : &buckets[i];
  }
  const uint8_t* key_at(const Bucket* b) const {
    return (mapped() ? mblob : blob.data()) + b->key_off;
  }
};

static void store_rehash(Store* s, uint64_t new_cap) {
  std::vector<Bucket> nb(new_cap);
  memset(nb.data(), 0, new_cap * sizeof(Bucket));
  for (uint64_t i = 0; i < s->capacity; ++i) {
    const Bucket& b = s->buckets[i];
    if (!b.hash) continue;
    uint64_t j = b.hash & (new_cap - 1);
    while (nb[j].hash) j = (j + 1) & (new_cap - 1);
    nb[j] = b;
  }
  s->buckets.swap(nb);
  s->capacity = new_cap;
}

void* ph_store_create(uint64_t capacity_hint) {
  Store* s = new Store();
  uint64_t cap = 64;
  while (cap < capacity_hint * 2) cap <<= 1;
  s->buckets.assign(cap, Bucket{0, 0, 0, 0});
  s->capacity = cap;
  return s;
}

void ph_store_close(void* h) {
  Store* s = static_cast<Store*>(h);
  if (s->map_base) munmap(s->map_base, s->map_size);
  delete s;
}

uint64_t ph_store_size(void* h) { return static_cast<Store*>(h)->n; }

// Lookup; -1 when absent.
int32_t ph_store_get(void* h, const uint8_t* key, uint32_t len) {
  Store* s = static_cast<Store*>(h);
  uint64_t hash = fnv1a(key, len);
  uint64_t mask = s->capacity - 1;
  uint64_t j = hash & mask;
  for (;;) {
    const Bucket* b = s->bucket_at(j);
    if (!b->hash) return -1;
    if (b->hash == hash && b->key_len == len &&
        memcmp(s->key_at(b), key, len) == 0)
      return b->id;
    j = (j + 1) & mask;
  }
}

// Insert-if-absent with the next sequential id; returns the id either way.
// Mutable-mode stores only (mapped stores are frozen by construction).
int32_t ph_store_insert(void* h, const uint8_t* key, uint32_t len) {
  Store* s = static_cast<Store*>(h);
  if (s->mapped()) return ph_store_get(h, key, len);
  if ((s->n + 1) * 10 > s->capacity * 7) store_rehash(s, s->capacity * 2);
  uint64_t hash = fnv1a(key, len);
  uint64_t mask = s->capacity - 1;
  uint64_t j = hash & mask;
  for (;;) {
    Bucket& b = s->buckets[j];
    if (!b.hash) {
      b.hash = hash;
      b.key_off = s->blob.size();
      b.key_len = len;
      b.id = static_cast<int32_t>(s->n++);
      s->blob.insert(s->blob.end(), key, key + len);
      return b.id;
    }
    if (b.hash == hash && b.key_len == len &&
        memcmp(s->key_at(&b), key, len) == 0)
      return b.id;
    j = (j + 1) & mask;
  }
}

// keys_blob: concatenated utf-8 keys; offsets: (n+1) u64 prefix offsets.
void ph_store_lookup_batch(void* h, const uint8_t* keys_blob,
                           const uint64_t* offsets, uint64_t n,
                           int32_t* out_ids) {
  for (uint64_t i = 0; i < n; ++i) {
    out_ids[i] = ph_store_get(h, keys_blob + offsets[i],
                              static_cast<uint32_t>(offsets[i + 1] - offsets[i]));
  }
}

void ph_store_insert_batch(void* h, const uint8_t* keys_blob,
                           const uint64_t* offsets, uint64_t n,
                           int32_t* out_ids) {
  for (uint64_t i = 0; i < n; ++i) {
    out_ids[i] = ph_store_insert(h, keys_blob + offsets[i],
                                 static_cast<uint32_t>(offsets[i + 1] - offsets[i]));
  }
}

// Dump keys in id order: fills lens[n]; blob receives concatenated keys (pass
// blob=nullptr first to size it via return value).
uint64_t ph_store_dump(void* h, uint32_t* lens, uint8_t* blob) {
  Store* s = static_cast<Store*>(h);
  uint64_t total = 0;
  std::vector<const Bucket*> by_id(s->n, nullptr);
  for (uint64_t i = 0; i < s->capacity; ++i) {
    const Bucket* b = s->bucket_at(i);
    if (b->hash) by_id[b->id] = b;
  }
  for (uint64_t i = 0; i < s->n; ++i) {
    const Bucket* b = by_id[i];
    if (lens) lens[i] = b->key_len;
    if (blob) {
      memcpy(blob + total, s->key_at(b), b->key_len);
    }
    total += b->key_len;
  }
  return total;
}

static const char STORE_MAGIC[8] = {'P', 'H', 'I', 'X', '1', 0, 0, 0};

int32_t ph_store_save(void* h, const char* path) {
  Store* s = static_cast<Store*>(h);
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t blob_size = s->mapped() ? s->map_size : s->blob.size();
  const uint8_t* blob = s->mapped() ? s->mblob : s->blob.data();
  if (s->mapped()) {
    // recompute blob size for mapped stores: sum of key lens
    blob_size = 0;
    for (uint64_t i = 0; i < s->capacity; ++i) {
      const Bucket* b = s->bucket_at(i);
      if (b->hash) blob_size += b->key_len;
    }
  }
  fwrite(STORE_MAGIC, 1, 8, f);
  fwrite(&s->n, 8, 1, f);
  fwrite(&s->capacity, 8, 1, f);
  fwrite(&blob_size, 8, 1, f);
  const Bucket* bptr = s->mapped() ? s->mbuckets : s->buckets.data();
  fwrite(bptr, sizeof(Bucket), s->capacity, f);
  fwrite(blob, 1, blob_size, f);
  fclose(f);
  return 0;
}

void* ph_store_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  const uint8_t* p = static_cast<const uint8_t*>(base);
  if (memcmp(p, STORE_MAGIC, 8) != 0) {
    munmap(base, st.st_size);
    return nullptr;
  }
  Store* s = new Store();
  memcpy(&s->n, p + 8, 8);
  memcpy(&s->capacity, p + 16, 8);
  s->map_base = base;
  s->map_size = st.st_size;
  s->mbuckets = reinterpret_cast<const Bucket*>(p + 32);
  s->mblob = p + 32 + s->capacity * sizeof(Bucket);
  return s;
}

// ===========================================================================
// Avro TrainingExampleAvro block decoder.
//
// Decodes one decompressed container-file block (`count` records) into
// columnar outputs. The record layout is described by a field PLAN built in
// Python from the parsed schema — one (op, aux) pair per record field, in
// field order:
//   op 0: double scalar            -> scalar column aux (0=y, 1=offset, 2=weight)
//   op 1: union[null, double]      -> scalar column aux (null leaves default)
//   op 2: RETIRED (was opt-string skip; op 7 covers it)
//   op 3: union[null, string]      -> entity column aux
//   op 4: array<NameTermValue>     -> feature COO; aux = bag index
//   op 5: RETIRED (was string skip; op 7 covers it)
//   op 6: RETIRED (was long/int skip; op 7 covers it)
//   op 7: generic skip             -> aux = skip-program id (see below)
//   op 8: generic numeric scalar   -> aux packs slot | kind<<8 | mode<<16
//         kind 0=double 1=float 2=varint(int/long); mode 0=plain,
//         1=[null,X], 2=[X,null]
//   op 9: generic entity column    -> aux packs entity | mode<<16
//         mode 0=plain string, 1=[null,string], 2=[string,null]
//   op 10: map<string, double|float> -> feature COO; aux = bag index
//         (map key = feature name, no term; ntv_value_kind as op 4)
//
// SKIP PROGRAMS make every unconsumed field shape native: a schema is
// compiled into a table of small i32 programs (sk_prog flat array +
// sk_off[pid] starts), one per nested value shape:
//   [0]=null [1]=boolean [2]=varint(int/long/enum) [3]=float [4]=double
//   [5]=bytes/string [6,n]=fixed(n) [7,n,p1..pn]=union [8,n,p1..pn]=record
//   [9,p]=array [10,p]=map
// Anything else must be handled by the Python fallback (the plan builder
// refuses to emit a plan).
//
// Feature keys are name + '\x01' + term (term empty -> name alone),
// matching index_map.feature_key. Each bag can feed multiple shard stores
// (bag_targets); ids come from ph_store_get (frozen) or ph_store_insert
// (build mode). Unknown frozen keys are dropped, like the reference's
// scoring path.
// ===========================================================================

struct Decoded {
  std::vector<double> scalars[3];  // y, offset, weight
  std::vector<uint8_t> scalar_set[3];
  // entity columns: arena + per-record (off, len)
  std::vector<std::vector<uint8_t>> ent_arena;
  std::vector<std::vector<uint64_t>> ent_offsets;
  // per-store COO
  std::vector<std::vector<int64_t>> rows;
  std::vector<std::vector<int32_t>> cols;
  std::vector<std::vector<float>> vals;
  std::string error;
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
};

static inline int64_t read_long(Cursor* c) {
  uint64_t r = 0;
  int shift = 0;
  while (true) {
    if (c->p >= c->end || shift > 63) {  // shift guard: overlong varint
      c->ok = false;
      return 0;
    }
    uint8_t b = *c->p++;
    r |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  return static_cast<int64_t>(r >> 1) ^ -static_cast<int64_t>(r & 1);
}

static inline double read_double(Cursor* c) {
  if (c->p + 8 > c->end) {
    c->ok = false;
    return 0;
  }
  double v;
  memcpy(&v, c->p, 8);
  c->p += 8;
  return v;
}

static inline float read_float(Cursor* c) {
  if (c->p + 4 > c->end) {
    c->ok = false;
    return 0;
  }
  float v;
  memcpy(&v, c->p, 4);
  c->p += 4;
  return v;
}

// returns pointer+len of string payload (no copy). Compares against the
// REMAINING byte count (not `p + len > end`, whose pointer arithmetic
// overflows — UB — for huge corrupt lengths).
static inline const uint8_t* read_str(Cursor* c, int64_t* len) {
  *len = read_long(c);
  if (*len < 0 || *len > c->end - c->p) {
    c->ok = false;
    return nullptr;
  }
  const uint8_t* s = c->p;
  c->p += *len;
  return s;
}

// Recursive skip of one value described by skip program `pid`.
static void skip_value(Cursor* c, const int32_t* prog, const int32_t* off,
                       int32_t pid, int depth) {
  if (depth > 64 || pid < 0) {  // malicious nesting / bad plan
    c->ok = false;
    return;
  }
  const int32_t* q = prog + off[pid];
  switch (q[0]) {
    case 0:  // null
      return;
    case 1:  // boolean
      if (c->p >= c->end) c->ok = false;
      else ++c->p;
      return;
    case 2:  // int/long/enum varint
      read_long(c);
      return;
    case 3:
      read_float(c);
      return;
    case 4:
      read_double(c);
      return;
    case 5: {  // bytes/string
      int64_t len;
      read_str(c, &len);
      return;
    }
    case 6: {  // fixed(n)
      int64_t n = q[1];
      if (n > c->end - c->p) c->ok = false;
      else c->p += n;
      return;
    }
    case 7: {  // union: branch varint then that branch's program
      int64_t b = read_long(c);
      if (!c->ok) return;
      if (b < 0 || b >= q[1]) {
        c->ok = false;
        return;
      }
      skip_value(c, prog, off, q[2 + b], depth + 1);
      return;
    }
    case 8: {  // record: fields in order
      for (int32_t i = 0; i < q[1] && c->ok; ++i)
        skip_value(c, prog, off, q[2 + i], depth + 1);
      return;
    }
    case 9:    // array of q[1]
    case 10: {  // map of q[1] (string keys)
      for (;;) {
        int64_t bn = read_long(c);
        if (!c->ok || bn == 0) return;
        if (bn < 0) {
          read_long(c);  // block byte size
          bn = -bn;
        }
        for (int64_t k = 0; k < bn && c->ok; ++k) {
          if (q[0] == 10) {
            int64_t len;
            read_str(c, &len);
            if (!c->ok) return;
          }
          skip_value(c, prog, off, q[1], depth + 1);
        }
      }
    }
    default:
      c->ok = false;
  }
}

// One buffered NameTermValue within the current record.
struct BagEntry {
  uint64_t key_off;
  uint32_t key_len;
  float value;
};

// plan op aux packing: ops[i], aux[i] arrays.
// Per-store bag order: store s consumes bags store_bag_idx[store_bag_off[s]
// .. store_bag_off[s+1]) IN THAT ORDER — matching the Python
// build_index_map's per-record `for bag in config.bags` id-assignment order,
// not the schema's field order. Bag entries are buffered per record and
// flushed per store at record end.
void* ph_decode_block(const uint8_t* payload, uint64_t payload_len,
                      uint64_t count, uint64_t row0,
                      const int32_t* ops, const int32_t* aux, int32_t n_ops,
                      const int32_t* ntv_value_kind,  // per bag: 0=double,
                                                      // 1=float, 2=long/int
                      int32_t n_bags,
                      const int32_t* store_bag_off,
                      const int32_t* store_bag_idx,
                      void** stores, int32_t n_stores, int32_t n_entities,
                      int32_t build_mode,
                      const int32_t* sk_prog, const int32_t* sk_off,
                      // scalar/entity union branch tables (ops 11/12):
                      // table t = bt_flat[bt_off[t] .. ]: [n_branches,
                      // code...] with code -2 = the consumed branch,
                      // -1 = null/unset, >=0 = skip-program id (unset).
                      const int32_t* bt_flat, const int32_t* bt_off) {
  Decoded* out = new Decoded();
  for (int k = 0; k < 3; ++k) {
    out->scalars[k].assign(count, 0.0);
    out->scalar_set[k].assign(count, 0);
  }
  out->ent_arena.resize(n_entities);
  // len slot UINT64_MAX = null sentinel (distinguishes a null union branch
  // from a legitimately empty string).
  out->ent_offsets.assign(
      n_entities, std::vector<uint64_t>(2 * count, ~uint64_t(0)));
  for (int e = 0; e < n_entities; ++e)
    for (uint64_t r = 0; r < count; ++r) out->ent_offsets[e][2 * r] = 0;
  out->rows.resize(n_stores);
  out->cols.resize(n_stores);
  out->vals.resize(n_stores);

  Cursor c{payload, payload + payload_len};
  std::vector<uint8_t> key_arena;                    // per-record key bytes
  std::vector<std::vector<BagEntry>> bag_entries(n_bags);
  for (uint64_t rec = 0; rec < count && c.ok; ++rec) {
    key_arena.clear();
    for (auto& v : bag_entries) v.clear();
    for (int32_t op_i = 0; op_i < n_ops && c.ok; ++op_i) {
      int32_t op = ops[op_i], a = aux[op_i];
      switch (op) {
        case 0: {
          out->scalars[a][rec] = read_double(&c);
          out->scalar_set[a][rec] = 1;
          break;
        }
        case 1: {  // [null, double]: branch outside {0,1} = corruption
          int64_t branch = read_long(&c);
          if (branch < 0 || branch > 1) {
            c.ok = false;
            break;
          }
          if (branch == 1) {
            out->scalars[a][rec] = read_double(&c);
            out->scalar_set[a][rec] = 1;
          }
          break;
        }
        case 3: {
          int64_t branch = read_long(&c);
          if (branch < 0 || branch > 1) {
            c.ok = false;
            break;
          }
          if (branch == 1) {
            int64_t len;
            const uint8_t* s = read_str(&c, &len);
            if (c.ok) {
              auto& arena = out->ent_arena[a];
              out->ent_offsets[a][2 * rec] = arena.size();
              out->ent_offsets[a][2 * rec + 1] = len;
              arena.insert(arena.end(), s, s + len);
            }
          }
          break;
        }
        case 4: {  // feature bag: buffer entries; stores flush at record end
          int bag = a & 0xFFFF, mode = (a >> 16) & 0xFF;
          if (mode != 0) {  // union-wrapped bag: [null, array] / [array, null]
            int64_t branch = read_long(&c);
            if (branch < 0 || branch > 1) {
              c.ok = false;
              break;
            }
            bool present = (mode == 1) ? (branch == 1) : (branch == 0);
            if (!present) break;  // null bag = no entries
          }
          int vkind = ntv_value_kind[bag];
          for (;;) {
            int64_t bn = read_long(&c);
            if (!c.ok || bn == 0) break;
            if (bn < 0) {
              read_long(&c);  // block byte size
              bn = -bn;
            }
            for (int64_t k = 0; k < bn && c.ok; ++k) {
              int64_t nlen, tlen;
              const uint8_t* name = read_str(&c, &nlen);
              const uint8_t* term = read_str(&c, &tlen);
              double value = vkind == 1   ? read_float(&c)
                             : vkind == 2 ? static_cast<double>(read_long(&c))
                                          : read_double(&c);
              if (!c.ok) break;
              uint64_t off = key_arena.size();
              key_arena.insert(key_arena.end(), name, name + nlen);
              uint32_t klen = static_cast<uint32_t>(nlen);
              if (tlen > 0) {
                key_arena.push_back(0x01);
                key_arena.insert(key_arena.end(), term, term + tlen);
                klen += 1 + static_cast<uint32_t>(tlen);
              }
              bag_entries[bag].push_back(
                  BagEntry{off, klen, static_cast<float>(value)});
            }
          }
          break;
        }
        // ops 2/5/6 (opt-string/string/long skips) are RETIRED: the plan
        // builder emits generic skip programs (op 7) for every unconsumed
        // field; their numbers stay reserved so op ids remain stable.
        case 7: {  // generic skip via compiled skip program
          skip_value(&c, sk_prog, sk_off, a, 0);
          break;
        }
        case 8: {  // generic numeric scalar
          int32_t slot = a & 0xFF, kind = (a >> 8) & 0xFF;
          int32_t mode = (a >> 16) & 0xFF;
          bool present = true;
          if (mode != 0) {
            int64_t branch = read_long(&c);
            if (branch < 0 || branch > 1) {
              c.ok = false;
              break;
            }
            present = (mode == 1) ? (branch == 1) : (branch == 0);
          }
          if (present && c.ok) {
            double v = kind == 0 ? read_double(&c)
                       : kind == 1 ? static_cast<double>(read_float(&c))
                                   : static_cast<double>(read_long(&c));
            if (c.ok) {
              out->scalars[slot][rec] = v;
              out->scalar_set[slot][rec] = 1;
            }
          }
          break;
        }
        case 9: {  // generic entity column
          int32_t ent = a & 0xFFFF, mode = (a >> 16) & 0xFF;
          bool present = true;
          if (mode != 0) {
            int64_t branch = read_long(&c);
            if (branch < 0 || branch > 1) {
              c.ok = false;
              break;
            }
            present = (mode == 1) ? (branch == 1) : (branch == 0);
          }
          if (present && c.ok) {
            int64_t len;
            const uint8_t* s = read_str(&c, &len);
            if (c.ok) {
              auto& arena = out->ent_arena[ent];
              out->ent_offsets[ent][2 * rec] = arena.size();
              out->ent_offsets[ent][2 * rec + 1] = len;
              arena.insert(arena.end(), s, s + len);
            }
          }
          break;
        }
        case 10: {  // map<string, double|float|long> feature bag
          int bag = a & 0xFFFF, mode = (a >> 16) & 0xFF;
          if (mode != 0) {  // union-wrapped map bag
            int64_t branch = read_long(&c);
            if (branch < 0 || branch > 1) {
              c.ok = false;
              break;
            }
            bool present = (mode == 1) ? (branch == 1) : (branch == 0);
            if (!present) break;
          }
          int vkind = ntv_value_kind[bag];
          for (;;) {
            int64_t bn = read_long(&c);
            if (!c.ok || bn == 0) break;
            if (bn < 0) {
              read_long(&c);  // block byte size
              bn = -bn;
            }
            for (int64_t k = 0; k < bn && c.ok; ++k) {
              int64_t klen;
              const uint8_t* kp = read_str(&c, &klen);
              double value = vkind == 1   ? read_float(&c)
                             : vkind == 2 ? static_cast<double>(read_long(&c))
                                          : read_double(&c);
              if (!c.ok) break;
              uint64_t off = key_arena.size();
              key_arena.insert(key_arena.end(), kp, kp + klen);
              bag_entries[bag].push_back(BagEntry{
                  off, static_cast<uint32_t>(klen),
                  static_cast<float>(value)});
            }
          }
          break;
        }
        case 11: {  // scalar behind an arbitrary union (branch table)
          int32_t slot = a & 0xFF, kind = (a >> 8) & 0xFF, bt = a >> 16;
          const int32_t* tab = bt_flat + bt_off[bt];
          int64_t branch = read_long(&c);
          if (!c.ok || branch < 0 || branch >= tab[0]) {
            c.ok = false;
            break;
          }
          int32_t code = tab[1 + branch];
          if (code == -2) {
            double v = kind == 0   ? read_double(&c)
                       : kind == 1 ? static_cast<double>(read_float(&c))
                                   : static_cast<double>(read_long(&c));
            if (c.ok) {
              out->scalars[slot][rec] = v;
              out->scalar_set[slot][rec] = 1;
            }
          } else if (code >= 0) {  // non-consumed branch: skip, stay unset
            skip_value(&c, sk_prog, sk_off, code, 0);
          }                        // code -1: null, unset
          break;
        }
        case 12: {  // entity string behind an arbitrary union
          int32_t ent = a & 0xFFFF, bt = a >> 16;
          const int32_t* tab = bt_flat + bt_off[bt];
          int64_t branch = read_long(&c);
          if (!c.ok || branch < 0 || branch >= tab[0]) {
            c.ok = false;
            break;
          }
          int32_t code = tab[1 + branch];
          if (code == -2) {
            int64_t len;
            const uint8_t* s = read_str(&c, &len);
            if (c.ok) {
              auto& arena = out->ent_arena[ent];
              out->ent_offsets[ent][2 * rec] = arena.size();
              out->ent_offsets[ent][2 * rec + 1] = len;
              arena.insert(arena.end(), s, s + len);
            }
          } else if (code >= 0) {
            skip_value(&c, sk_prog, sk_off, code, 0);
          }
          break;
        }
        default:
          c.ok = false;
      }
    }
    if (!c.ok) break;
    for (int32_t s_i = 0; s_i < n_stores; ++s_i) {
      void* st = stores[s_i];
      for (int32_t t = store_bag_off[s_i]; t < store_bag_off[s_i + 1]; ++t) {
        for (const BagEntry& e : bag_entries[store_bag_idx[t]]) {
          const uint8_t* key = key_arena.data() + e.key_off;
          int32_t id = build_mode ? ph_store_insert(st, key, e.key_len)
                                  : ph_store_get(st, key, e.key_len);
          if (id >= 0) {
            out->rows[s_i].push_back(static_cast<int64_t>(row0 + rec));
            out->cols[s_i].push_back(id);
            out->vals[s_i].push_back(e.value);
          }
        }
      }
    }
  }
  if (!c.ok) {
    out->error = "truncated or malformed Avro block";
  }
  return out;
}

int32_t ph_decoded_ok(void* h) {
  return static_cast<Decoded*>(h)->error.empty() ? 1 : 0;
}

// Copy scalar column k (with set mask) into out[count]/set[count].
void ph_decoded_scalars(void* h, int32_t k, double* out, uint8_t* set_mask) {
  Decoded* d = static_cast<Decoded*>(h);
  memcpy(out, d->scalars[k].data(), d->scalars[k].size() * 8);
  memcpy(set_mask, d->scalar_set[k].data(), d->scalar_set[k].size());
}

uint64_t ph_decoded_coo_size(void* h, int32_t store_i) {
  return static_cast<Decoded*>(h)->rows[store_i].size();
}

void ph_decoded_coo(void* h, int32_t store_i, int64_t* rows, int32_t* cols,
                    float* vals) {
  Decoded* d = static_cast<Decoded*>(h);
  auto& r = d->rows[store_i];
  memcpy(rows, r.data(), r.size() * 8);
  memcpy(cols, d->cols[store_i].data(), r.size() * 4);
  memcpy(vals, d->vals[store_i].data(), r.size() * 4);
}

uint64_t ph_decoded_entity_arena_size(void* h, int32_t e) {
  return static_cast<Decoded*>(h)->ent_arena[e].size();
}

void ph_decoded_entity(void* h, int32_t e, uint8_t* arena,
                       uint64_t* offsets) {
  Decoded* d = static_cast<Decoded*>(h);
  memcpy(arena, d->ent_arena[e].data(), d->ent_arena[e].size());
  memcpy(offsets, d->ent_offsets[e].data(),
         d->ent_offsets[e].size() * 8);
}

void ph_decoded_free(void* h) { delete static_cast<Decoded*>(h); }

// ---------------------------------------------------------------- snappy
// Raw Snappy block decompression (Avro "snappy" codec payloads; the pure-
// Python twin is photon_tpu/data/snappy.py — tests pin byte parity).
// Returns 0 on success; negative on malformed input.

// Uncompressed length from the preamble varint; -1 if malformed.
int64_t ph_snappy_length(const uint8_t* src, uint64_t src_len) {
  uint64_t out = 0;
  int shift = 0;
  for (uint64_t p = 0; p < src_len && shift <= 35; ++p) {
    out |= static_cast<uint64_t>(src[p] & 0x7F) << shift;
    if (!(src[p] & 0x80)) return static_cast<int64_t>(out);
    shift += 7;
  }
  return -1;
}

int32_t ph_snappy_uncompress(const uint8_t* src, uint64_t src_len,
                             uint8_t* dst, uint64_t dst_len) {
  uint64_t pos = 0, n = 0;
  {  // preamble varint
    int shift = 0;
    for (;; ++pos) {
      if (pos >= src_len || shift > 35) return -1;
      n |= static_cast<uint64_t>(src[pos] & 0x7F) << shift;
      if (!(src[pos] & 0x80)) { ++pos; break; }
      shift += 7;
    }
  }
  if (n != dst_len) return -2;
  uint64_t w = 0;
  while (pos < src_len) {
    uint8_t tag = src[pos++];
    uint32_t t = tag & 3;
    if (t == 0) {  // literal
      uint64_t len = tag >> 2;
      if (len >= 60) {
        uint32_t extra = static_cast<uint32_t>(len) - 59;
        if (pos + extra > src_len) return -3;
        len = 0;
        for (uint32_t i = 0; i < extra; ++i)
          len |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
        pos += extra;
      }
      ++len;
      if (pos + len > src_len || w + len > n) return -3;
      memcpy(dst + w, src + pos, len);
      pos += len;
      w += len;
      continue;
    }
    uint64_t len, off;
    if (t == 1) {
      if (pos >= src_len) return -4;
      len = ((tag >> 2) & 0x7) + 4;
      off = (static_cast<uint64_t>(tag >> 5) << 8) | src[pos++];
    } else if (t == 2) {
      if (pos + 2 > src_len) return -4;
      len = (tag >> 2) + 1;
      off = src[pos] | (static_cast<uint64_t>(src[pos + 1]) << 8);
      pos += 2;
    } else {
      if (pos + 4 > src_len) return -4;
      len = (tag >> 2) + 1;
      off = src[pos] | (static_cast<uint64_t>(src[pos + 1]) << 8) |
            (static_cast<uint64_t>(src[pos + 2]) << 16) |
            (static_cast<uint64_t>(src[pos + 3]) << 24);
      pos += 4;
    }
    if (off == 0 || off > w || w + len > n) return -4;
    if (off >= len) {
      memcpy(dst + w, dst + (w - off), len);
    } else {  // overlapping: the pattern repeats forward
      for (uint64_t i = 0; i < len; ++i) dst[w + i] = dst[w - off + i];
    }
    w += len;
  }
  return w == n ? 0 : -5;
}

}  // extern "C"
